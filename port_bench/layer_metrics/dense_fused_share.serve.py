"""``dense_fused_share.serve``: the share of ``dense`` calls that ran on the fused route, in
%: the program's ranges `FUSED` over those of `FUSED` and `EPILOGUE` (a bf16 call opens
the one or the other), in the traced window with host ops. A program that names no fused
span (``SPANS`` of `PROFILING`), or a window without either range, reads ``None``."""

import sys

EPILOGUE = "r3m.dense.epilogue"
FUSED = "r3m.dense.fused"
PROFILING = "r3m_tpu_torch.utils.profiling"


def read(ctx):
    if ctx.ops is None or FUSED not in getattr(sys.modules.get(PROFILING), "SPANS", ()):
        return None
    names = [name for items in ctx.ops.host_ops.values() for _, _, name in items]
    fused = names.count(FUSED)
    calls = fused + names.count(EPILOGUE)
    return 100.0 * fused / calls if calls else None
