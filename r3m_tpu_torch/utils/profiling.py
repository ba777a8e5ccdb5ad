"""Device traces with `torch.profiler`, and the op profile of one: the port's counterpart
of ``r3m_tpu/utils/profiling.py``'s ``jax.profiler`` traces and xprof op profiles.

`start_trace` / `stop_trace` bracket a region that spans calls (the workspace's profile
window); `trace` is the same as a context manager. The trace is written to `log_dir` as a
Chrome trace (``*.pt.trace.json``, readable in Perfetto or TensorBoard),
with the card's kernels where CUDA is available. `op_profile_raw` sums the newest such
trace's device events (kernels, copies and memsets) by name into the JAX function's rows,
`op_profile_summary` digests them into time shares and rates, and `print_op_profile`
prints them. A trace of the CPU alone has no device events and so no rows.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
from collections import defaultdict
from typing import List, Optional, Tuple

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


_DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")  # the `cat` of a device event


def op_profile_raw(log_dir: str, top: Optional[int] = None) -> Tuple[List[Tuple], int]:
    """The device events of the newest ``*.pt.trace.json`` under `log_dir`, summed by name.

    Returns ``([(time_ps, flops, bytes, occurrences, name), ...], total_time_ps)``, the
    JAX function's rows, heaviest first; the total is over every row, `top` or not. FLOPs
    are the events' ``args["flops"]`` where the profiler recorded them, else 0; bytes are
    0, since a Chrome trace carries none. Raises `FileNotFoundError` where `log_dir` holds
    no trace.
    """
    files = glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json"), recursive=True)
    if not files:
        raise FileNotFoundError(f"no *.pt.trace.json under {log_dir}")
    with open(max(files, key=os.path.getmtime)) as f:
        events = json.load(f).get("traceEvents", [])
    sums = defaultdict(lambda: [0, 0, 0])  # name -> [time_ps, flops, occurrences]
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in _DEVICE_EVENTS:
            acc = sums[ev["name"]]
            acc[0] += round(ev.get("dur", 0) * 1e6)  # microseconds -> picoseconds
            acc[1] += (ev.get("args") or {}).get("flops", 0)
            acc[2] += 1
    rows = sorted(((t, fl, 0, n, name) for name, (t, fl, n) in sums.items()), reverse=True)
    total = sum(r[0] for r in rows)
    return (rows[:top] if top else rows), total


def op_profile_summary(log_dir: str, top: int = 12) -> List[Tuple]:
    """``[(time_frac, tflops_per_s, gb_per_s, occurrences, name), ...]``, heaviest first,
    digested from `op_profile_raw`."""
    rows, total = op_profile_raw(log_dir, top)
    total = total or 1
    return [
        (
            t / total,
            fl / (t / 1e12) / 1e12 if t else 0.0,
            byt / (t / 1e12) / 1e9 if t else 0.0,
            occ,
            name,
        )
        for t, fl, byt, occ, name in rows
    ]


def print_op_profile(log_dir: str, top: int = 12) -> None:
    """Print `op_profile_summary`'s rows, one a line."""
    rows = op_profile_summary(log_dir, top)
    if not rows:
        # a trace of the CPU alone has no device events; say so rather than print nothing
        print(f"(no device kernels in the trace under {log_dir}: a CPU-only trace)")
    for frac, tf, gb, occ, name in rows:
        print(f"{100*frac:5.1f}%  {tf:6.1f} TF/s  {gb:6.0f} GB/s  x{occ:5d}  {name}")
