"""``optimizer_ms.train``: device ms a step of the kernels launched inside the train step's
optimizer phase (the gradients cleared, their norm, the learning rate, Adam's update):
the program's span `SPAN`."""

from port_bench import spans

SPAN = "r3m.step.optimizer"


def read(ctx):
    return spans.phase_ms(ctx, SPAN)
