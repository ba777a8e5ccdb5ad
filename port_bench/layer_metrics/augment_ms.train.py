"""``augment_ms.train``: device ms a step of the kernels launched inside the train step's
augment phase (the batch's placement, the crop and permutation draws, RandomResizedCrop):
the program's span `SPAN`."""

from port_bench import spans

SPAN = "r3m.step.augment"


def read(ctx):
    return spans.phase_ms(ctx, SPAN)
