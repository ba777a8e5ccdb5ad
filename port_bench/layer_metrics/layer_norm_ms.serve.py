"""``layer_norm_ms.serve``: device ms a request of the ViT's and DINOv2's LayerNorm
forwards: the kernels launched inside the program's span `SPANS` (one kernel a call on
the card since the span came; a program without the span reads ``None``)."""

from port_bench import spans

SPANS = ("r3m.layer_norm",)


def read(ctx):
    return spans.device_ms(ctx, SPANS)
