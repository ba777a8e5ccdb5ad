"""``layerscale_ms.serve``: device ms a request of DINOv2's LayerScale products with their
residual adds: the kernels launched inside the program's span `SPANS`."""

from port_bench import spans

SPANS = ("r3m.layerscale",)


def read(ctx):
    return spans.device_ms(ctx, SPANS)
