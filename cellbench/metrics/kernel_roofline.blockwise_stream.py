"""kernel_roofline.blockwise_stream (kernels layer): the least time for the
matvecs of the traced window (A and x read once, y written once, against
the larger of the byte and operation bounds) over the device time of all
kernels in it, summed over the cell's cards. Each card's HBM reads its
own quarter of A, so the four cards' kernel time weighs against one card's
bound for the whole of A: the yardstick of ``kernel_roofline.matvec``."""

from cellbench.harness import roofline


def read(ctx):
    if ctx.trace is None or ctx.trace.kernel_s <= 0:
        return None
    work = roofline.matvec_work(ctx.cfg["m"], ctx.cfg["k"], ctx.cfg["dtype"])
    return roofline.share_percent(len(ctx.record.index) * work.least_seconds(),
                                  ctx.trace.kernel_s)
