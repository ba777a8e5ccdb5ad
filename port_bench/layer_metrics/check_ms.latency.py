"""``check_ms.latency``: the median host ms of ``R3MEncoder``'s check of its serving
weights (whether they are stale, and their refold) in a request: the program's span
`SPAN`, in the traced window with host ops."""

from port_bench import spans

SPAN = "r3m.encoder.check"


def read(ctx):
    return spans.host_ms_median(ctx, SPAN)
