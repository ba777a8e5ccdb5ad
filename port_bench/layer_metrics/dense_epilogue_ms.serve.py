"""``dense_epilogue_ms.serve``: device ms a request of the ViT's ``dense`` epilogue, the
f32 bias add and the cast back after each product: the kernels launched inside the
program's span `SPANS`."""

from port_bench import spans

SPANS = ("r3m.dense.epilogue",)


def read(ctx):
    return spans.device_ms(ctx, SPANS)
