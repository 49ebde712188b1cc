"""kernel_roofline.solve (kernels layer): the least time for the CG
iterations the solves of the traced window report (A once an iteration,
and the vectors CG reads and writes), over the device time of all kernels
in it."""

from cellbench.harness import roofline


def read(ctx):
    iters = [i for i in ctx.record.iters if i is not None]
    if ctx.trace is None or ctx.trace.kernel_s <= 0 or not iters:
        return None
    work = roofline.cg_iteration_work(ctx.cfg["k"], ctx.cfg["dtype"])
    return roofline.share_percent(sum(iters) * work.least_seconds(), ctx.trace.kernel_s)
