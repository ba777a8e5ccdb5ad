"""``maxpool_roofline.train``: the stem max-pool's least time over its device time in a
step, in %. The work is the op's, from the step's shapes (`port_bench.flops`: forward with
its argmax, and backward, once a step each); the kernels that count as the op are
`NAMES`."""

from port_bench import flops, trace

NAMES = ("maxpool3x3s2_kernel", "maxpool3x3s2_bwd_kernel")


def read(ctx):
    if ctx.ops is None or not ctx.ops_units:
        return None
    spent = trace.device_seconds(ctx.ops, names=NAMES)
    if not spent:
        return None
    dtype = ctx.config["model"]["compute_dtype"]
    n, h, w, c = flops.stem_pool_input(ctx.config, ctx.mix["clips"] * ctx.mix["frames"])
    least = (flops.bound_s(*flops.maxpool_fwd(n, h, w, c, dtype, True), dtype)[0]
             + flops.bound_s(*flops.maxpool_bwd(n, h, w, c, dtype), dtype)[0])
    return 100.0 * least * ctx.ops_units / spent
