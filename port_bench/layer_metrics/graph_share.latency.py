"""``graph_share.latency``: the share of ``R3MEncoder``'s forwards that replayed a CUDA
graph, in %: the program's ranges `REPLAY` over those of `REPLAY` and `EMBED` (a call's
forward on one device is the one or the other), in the traced window with host ops. Not
over the ranges of ``r3m.encoder``: `trace.reduce` keeps one host op a correlation id, and
the profiler's own ``Activity Buffer Request`` and ``Buffer Flush`` events take the id of
about one replay range in seventy, which the count of calls would miss. A program that
names no such span (``SPANS`` of `PROFILING`), or a window without either range, reads
``None``."""

import sys

EMBED = "r3m.encoder.embed"
REPLAY = "r3m.encoder.replay"
PROFILING = "r3m_tpu_torch.utils.profiling"


def read(ctx):
    if ctx.ops is None or REPLAY not in getattr(sys.modules.get(PROFILING), "SPANS", ()):
        return None
    names = [name for items in ctx.ops.host_ops.values() for _, _, name in items]
    replays = names.count(REPLAY)
    forwards = replays + names.count(EMBED)
    return 100.0 * replays / forwards if forwards else None
