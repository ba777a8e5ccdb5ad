"""Time under the program's own spans (``r3m_tpu_torch.utils.profiling.SPANS``): the
ranges the system records while a profiler records, read from a traced window with host
ops (`harness.Context.ops`). A window in which a reader's span was never opened, as in a
program without such spans, reads ``None``."""

from __future__ import annotations

import statistics
from typing import Optional, Sequence

from port_bench import trace

# The train step's phases, which partition it. A kernel counts for the innermost phase in
# its chain of launching ops: the window's nesting can put a range of one step around the
# ops of the next (torch's own ``Optimizer.step#...`` annotation has a copy on the
# device's timeline, under the host range's id, which lasts until the card has run it).
STEP_PHASES = ("r3m.step.augment", "r3m.step.language", "r3m.step.encode", "r3m.step.loss",
               "r3m.step.backward", "r3m.step.optimizer")


def _recorded(win: trace.Window, names: Sequence[str]) -> bool:
    """Whether any thread of `win` ran a host op or range named one of `names`."""
    return any(name in names for items in win.host_ops.values() for _, _, name in items)


def _under(ops: Sequence[str], names: Sequence[str], prefixes: tuple,
           family: Sequence[str]) -> bool:
    for op in ops:
        if op in names or op.startswith(prefixes):
            return True
        if op in family:
            return False
    return False


def device_ms(ctx, names: Sequence[str], prefixes: Sequence[str] = (),
              family: Sequence[str] = ()) -> Optional[float]:
    """Device ms a unit (step or request) of the ops window's kernels whose chain of
    launching ops holds a range named one of `names`, or an op whose name starts with one
    of `prefixes`, before any other range of `family`; ``None`` where the window holds no
    device event (a run on the CPU)."""
    win = ctx.ops
    if win is None or not ctx.ops_units or not win.events or not _recorded(win, names):
        return None
    prefixes = tuple(prefixes)
    seconds = sum(ev.seconds for ev in win.events
                  if ev.kind == "kernel" and _under(ev.ops, names, prefixes, family))
    return 1e3 * seconds / ctx.ops_units


def phase_ms(ctx, phase: str, prefixes: Sequence[str] = ()) -> Optional[float]:
    """`device_ms` of the train step's `phase`, one of `STEP_PHASES`."""
    return device_ms(ctx, (phase,), prefixes, STEP_PHASES)


def host_ms_median(ctx, name: str) -> Optional[float]:
    """The median host ms of the ops window's ranges named `name`, on every thread."""
    if ctx.ops is None:
        return None
    spans = [(e - s) / 1e6 for items in ctx.ops.host_ops.values() for s, e, n in items
             if n == name]
    return statistics.median(spans) if spans else None
