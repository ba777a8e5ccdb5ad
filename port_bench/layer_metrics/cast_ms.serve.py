"""``cast_ms.serve``: device ms a request in dtype conversions: the kernels launched under a
host op named in `OPS` (``Tensor.to(dtype)``; copies between devices are not kernels)."""

from port_bench import trace

OPS = ("aten::_to_copy",)


def read(ctx):
    if ctx.ops is None or not ctx.ops_units:
        return None
    s = trace.device_seconds(ctx.ops, ops=OPS)
    return 1e3 * s / ctx.ops_units if s else None
