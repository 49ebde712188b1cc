"""cg_iters.solve (solver loop layer): mean iterations a solve, as each
SolverFuture result reports (a count the program makes)."""


def read(ctx):
    iters = [i for i in ctx.record.iters if i is not None]
    if not iters:
        return None
    return sum(iters) / len(iters)
