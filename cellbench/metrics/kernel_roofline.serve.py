"""kernel_roofline.serve (kernels layer): the least time for the requests
of the traced window, each at its own width (A once, its w columns of X and
of Y, 2·m·k·w operations; no bucket padding), over the device time of all
kernels in it."""

from cellbench.harness import roofline


def read(ctx):
    if ctx.trace is None or ctx.trace.kernel_s <= 0:
        return None
    m, k, dtype = ctx.cfg["m"], ctx.cfg["k"], ctx.cfg["dtype"]
    least = sum(roofline.block_work(m, k, w, dtype).least_seconds() for w in ctx.record.width)
    return roofline.share_percent(least, ctx.trace.kernel_s)
