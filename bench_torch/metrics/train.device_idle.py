"""Idle share of the card over the traced training window: 1 - the union of
the device's kernel, copy and fill intervals over the window's wall (%)."""


def read(ctx):
    if ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
