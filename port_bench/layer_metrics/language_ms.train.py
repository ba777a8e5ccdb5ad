"""``language_ms.train``: device ms a step of the kernels launched inside the train step's
language phase (the frozen DistilBERT's sentence embedding): the program's span
`SPAN`."""

from port_bench import spans

SPAN = "r3m.step.language"


def read(ctx):
    return spans.phase_ms(ctx, SPAN)
