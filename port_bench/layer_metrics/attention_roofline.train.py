"""``attention_roofline.train``: the ViT's attention's least time over its device time in
a step, in %. The work is the op's, from the step's shapes (`port_bench.flops`: forward
and backward in every layer); the kernels that count as the op are `NAMES`."""

from port_bench import flops, trace

NAMES = ("attention_fwd_", "attention_bwd_")


def read(ctx):
    if ctx.ops is None or not ctx.ops_units:
        return None
    spent = trace.device_seconds(ctx.ops, names=NAMES)
    if not spent:
        return None
    dtype = ctx.config["model"]["compute_dtype"]
    shape = flops.vit_attention_shape(ctx.config, ctx.mix["clips"] * ctx.mix["frames"])
    least = (flops.bound_s(*flops.attention_fwd(*shape, dtype), dtype)[0]
             + flops.bound_s(*flops.attention_bwd(*shape, dtype), dtype)[0])
    layers = ctx.config["backbone"]["n_layers"]
    return 100.0 * least * layers * ctx.ops_units / spent
