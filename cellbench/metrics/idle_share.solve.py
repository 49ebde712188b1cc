"""idle_share.solve (device layer): the share of the traced window in which no
kernel, copy or set ran on the card."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
