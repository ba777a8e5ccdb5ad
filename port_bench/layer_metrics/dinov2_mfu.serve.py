"""``dinov2_mfu.serve``: the model FLOPs of the DINOv2 requests the traced run's untraced
window completed (`port_bench.dinov2_flops.serve_request_flops`: the backbone's forward
over each request's frames) over the window's time and the card's peak in the precision
the requests are served in (bf16 for "fast", f32 for "parity"), in %."""

from port_bench import dinov2_flops, flops

PEAK = {"fast": "bfloat16", "parity": "float32"}


def read(ctx):
    if not ctx.units:
        return None
    work = dinov2_flops.serve_request_flops(ctx.config, ctx.mix) * ctx.units
    return 100.0 * work / ctx.window_s / flops.PEAK_FLOPS[PEAK[ctx.mix["precision"]]]
