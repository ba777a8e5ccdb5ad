"""``attention_roofline.serve``: the ViT's attention's least time over its device time in
a request, in %. The work is the op's, from the request's shapes (`port_bench.flops`: the
forward in every layer, in the dtype the request is served in); the kernels that count as
the op are `NAMES`."""

from port_bench import flops, trace

NAMES = ("attention_fwd_",)
DTYPE = {"fast": "bfloat16", "parity": "float32"}


def read(ctx):
    if ctx.ops is None or not ctx.ops_units:
        return None
    spent = trace.device_seconds(ctx.ops, names=NAMES)
    if not spent:
        return None
    dtype = DTYPE[ctx.mix["precision"]]
    shape = flops.vit_attention_shape(ctx.config, ctx.mix["frames"])
    least = flops.bound_s(*flops.attention_fwd(*shape, dtype), dtype)[0]
    return 100.0 * least * ctx.config["backbone"]["n_layers"] * ctx.ops_units / spent
