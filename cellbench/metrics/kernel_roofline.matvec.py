"""kernel_roofline.matvec (kernels layer): the least time for the matvecs
of the traced window (A and x read once, y written once, against the
larger of the byte and operation bounds) over the device time of all
kernels in it."""

from cellbench.harness import roofline


def read(ctx):
    if ctx.trace is None or ctx.trace.kernel_s <= 0:
        return None
    work = roofline.matvec_work(ctx.cfg["m"], ctx.cfg["k"], ctx.cfg["dtype"])
    return roofline.share_percent(len(ctx.record.index) * work.least_seconds(),
                                  ctx.trace.kernel_s)
