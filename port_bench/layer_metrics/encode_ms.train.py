"""``encode_ms.train``: device ms a step of the kernels launched inside the train step's
encode phase (the backbone's forward in train mode): the program's span `SPAN`."""

from port_bench import spans

SPAN = "r3m.step.encode"


def read(ctx):
    return spans.phase_ms(ctx, SPAN)
