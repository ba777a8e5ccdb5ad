"""``loss_ms.train``: device ms a step of the kernels launched inside the train step's loss
phase (the reward head, the TCN, language and L1/L2 losses, the metrics' sums and means):
the program's span `SPAN`."""

from port_bench import spans

SPAN = "r3m.step.loss"


def read(ctx):
    return spans.phase_ms(ctx, SPAN)
