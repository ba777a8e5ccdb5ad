"""``h2d_ms.serve``: device ms a request in host-to-device copies (the request's frames
from pageable host memory)."""

from port_bench import trace

NAMES = ("HtoD",)


def read(ctx):
    if ctx.ops is None or not ctx.ops_units:
        return None
    s = trace.device_seconds(ctx.ops, names=NAMES, kinds=("gpu_memcpy",))
    return 1e3 * s / ctx.ops_units if s else None
