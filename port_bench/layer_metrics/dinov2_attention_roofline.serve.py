"""``dinov2_attention_roofline.serve``: DINOv2's attention's least time over its device time
in a request, in %. The work is the op's, from the request's shapes (every layer's forward
at 1 + registers + patches tokens, in the dtype the request is served in:
`port_bench.dinov2_flops.attention_request_bound_s`); the kernels that count as the op are
`NAMES`."""

from port_bench import dinov2_flops, trace

NAMES = ("attention_fwd_",)
DTYPE = {"fast": "bfloat16", "parity": "float32"}


def read(ctx):
    if ctx.ops is None or not ctx.ops_units:
        return None
    spent = trace.device_seconds(ctx.ops, names=NAMES)
    if not spent:
        return None
    least = dinov2_flops.attention_request_bound_s(ctx.config, ctx.mix,
                                                   DTYPE[ctx.mix["precision"]])
    return 100.0 * least * ctx.ops_units / spent
