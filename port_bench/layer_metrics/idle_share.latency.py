"""``idle_share.latency``: the share of the traced window in which no kernel, copy or set
ran on the device, in %: one minus the union of the device events' spans over the
window's host-clock length, both from the same trace."""


def read(ctx):
    if ctx.window is None or not ctx.window.events:
        return None
    return 100.0 * (1.0 - ctx.window.busy_s / ctx.window.window_s)
