"""Device traces with `torch.profiler`: the port's counterpart of ``jax.profiler`` traces
(``r3m_tpu/utils/profiling.py:25``).

`start_trace` / `stop_trace` bracket a region that spans calls (the workspace's profile
window); `trace` is the same as a context manager. The trace is written to `log_dir` as a
Chrome trace (``*.pt.trace.json``, readable in Perfetto or TensorBoard),
with the card's kernels where CUDA is available. The JAX package's xprof op-profile
parsers have no counterpart here.
"""

from __future__ import annotations

import contextlib
import os

import torch


def start_trace(log_dir: str) -> torch.profiler.profile:
    """Start recording host and (where available) CUDA activity; returns the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    )
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile) -> None:
    """Stop `prof` and write its trace (after the card's queued work has finished)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()


@contextlib.contextmanager
def trace(log_dir: str):
    """Context manager: a Chrome trace of the block in `log_dir`."""
    prof = start_trace(log_dir)
    try:
        yield prof
    finally:
        stop_trace(prof)
