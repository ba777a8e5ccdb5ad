"""``step_mfu.train``: the model FLOPs of the steps the traced run's untraced window
completed (`port_bench.flops.train_step_flops`: the encoder and reward head forward and
backward, DistilBERT forward, no recomputation) over the window's time and the card's peak
in the step's compute dtype, in %."""

from port_bench import flops


def read(ctx):
    if not ctx.units:
        return None
    work = sum(flops.train_step_flops(ctx.config, ctx.mix).values()) * ctx.units
    peak = flops.PEAK_FLOPS[ctx.config["model"]["compute_dtype"]]
    return 100.0 * work / ctx.window_s / peak
