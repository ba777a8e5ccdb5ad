"""Device traces with `torch.profiler`, and the op profile of one: the port's counterpart
of ``r3m_tpu/utils/profiling.py``'s ``jax.profiler`` traces and xprof op profiles.

`start_trace` / `stop_trace` bracket a region that spans calls (the workspace's profile
window); `trace` is the same as a context manager. The trace is written to `log_dir` as a
Chrome trace (``*.pt.trace.json``, readable in Perfetto or TensorBoard),
with the card's kernels where CUDA is available. `op_profile_raw` sums the newest such
trace's device events (kernels, copies and memsets) by name into the JAX function's rows,
`op_profile_summary` digests them into time shares and rates, and `print_op_profile`
prints them. A trace of the CPU alone has no device events and so no rows.

`span(name)` marks a region of the program in whatever `torch.profiler` is recording: the
workspace's profile window, a benchmark's traced window or a user's own profiler. While
one records it is a range the trace holds as a host op named `name`, on the host's
timeline around the ops inside it, whose kernels carry their launching op's id; otherwise
it is a shared null context, and costs one attribute read. The program's spans, `SPANS`:

- ``r3m.step``: one call of the train step (`make_train_step`). Six phases partition it:
  ``r3m.step.augment`` (the batch's placement, the crop and permutation draws from the
  state's generator, RandomResizedCrop), ``r3m.step.language`` (DistilBERT's sentence
  embedding), ``r3m.step.encode`` (the backbone's forward and, over several cards, the
  gather of the embeddings; once a microbatch), ``r3m.step.loss`` (the R3M losses and the
  metrics' sums, once a microbatch; then the metrics' means), ``r3m.step.backward`` (the
  backward call; once a microbatch) and ``r3m.step.optimizer`` (clearing the gradients
  before the microbatches; then the gradients' average over the cards, their norm, the
  learning rate and the update). On the card the autograd engine launches the
  backward's kernels from a thread of its own, under ``autograd::engine::evaluate_function``
  ops rather than under ``r3m.step.backward``.
- ``r3m.encoder``: one call of `R3MEncoder`, with ``r3m.encoder.check`` (whether the
  serving weights are stale, and their refold), ``r3m.encoder.h2d`` (each part of the
  batch moved to its device) and ``r3m.encoder.embed`` (each part's forward).
- ``r3m.dense.epilogue``: the f32 bias add and the cast back of the ViT's `dense`.
- ``r3m.workspace.input_wait``: the workspace's train loop waiting for its next batch on
  the device.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
from collections import defaultdict
from typing import List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

STEP = "r3m.step"
STEP_AUGMENT = "r3m.step.augment"
STEP_LANGUAGE = "r3m.step.language"
STEP_ENCODE = "r3m.step.encode"
STEP_LOSS = "r3m.step.loss"
STEP_BACKWARD = "r3m.step.backward"
STEP_OPTIMIZER = "r3m.step.optimizer"
ENCODER = "r3m.encoder"
ENCODER_CHECK = "r3m.encoder.check"
ENCODER_H2D = "r3m.encoder.h2d"
ENCODER_EMBED = "r3m.encoder.embed"
DENSE_EPILOGUE = "r3m.dense.epilogue"
WORKSPACE_INPUT_WAIT = "r3m.workspace.input_wait"
STEP_PHASES = (STEP_AUGMENT, STEP_LANGUAGE, STEP_ENCODE, STEP_LOSS, STEP_BACKWARD,
               STEP_OPTIMIZER)
SPANS = (STEP, *STEP_PHASES, ENCODER, ENCODER_CHECK, ENCODER_H2D, ENCODER_EMBED,
         DENSE_EPILOGUE, WORKSPACE_INPUT_WAIT)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking `name` (one of `SPANS`) in the trace that a
    `torch.profiler` is recording; with none recording, a shared null context. A plain
    function, so that the untraced path reads one flag.

    The range is a function-scope record (``_RecordFunctionFast``), which the trace keeps
    on the host's timeline alone. A ``record_function`` range is a user annotation, which
    CUDA traces copy onto the device's timeline under the same id, so that a reader
    pairing events by id may take the device's copy for the host's range; it also costs
    several times more a range, with or without a profiler."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF


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
