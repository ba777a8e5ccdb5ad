"""``norm_ms.train``: device ms a step in BatchNorm: the kernels launched by a host op
whose name holds one of `OPS` (forward and backward, cuDNN's or torch's own)."""

from port_bench import trace

OPS = ("batch_norm",)


def read(ctx):
    if ctx.ops is None or not ctx.ops_units:
        return None
    s = trace.device_seconds(ctx.ops, ops=OPS)
    return 1e3 * s / ctx.ops_units if s else None
