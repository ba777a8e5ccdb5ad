"""``swiglu_gate_ms.serve``: device ms a request of DINOv2's SwiGLU gate, the
``silu(x1) * x2`` pass over the halves of ``weights_in``: the kernels launched inside the
program's span `SPANS`."""

from port_bench import spans

SPANS = ("r3m.swiglu.gate",)


def read(ctx):
    return spans.device_ms(ctx, SPANS)
