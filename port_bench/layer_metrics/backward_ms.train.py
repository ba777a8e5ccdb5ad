"""``backward_ms.train``: device ms a step of the backward's kernels: those launched inside
the train step's backward phase (the program's span `SPAN`), and those the autograd
engine launches from its own thread, under an op whose name starts with one of
`PREFIXES`. A window without the span reads nothing."""

from port_bench import spans

SPAN = "r3m.step.backward"
PREFIXES = ("autograd::engine::evaluate_function",)


def read(ctx):
    return spans.phase_ms(ctx, SPAN, PREFIXES)
