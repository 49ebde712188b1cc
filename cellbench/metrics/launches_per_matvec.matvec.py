"""launches_per_matvec.matvec (strategy layer): kernels the card ran in
the traced window over the matvecs called in it, whatever their names."""


def read(ctx):
    calls = len(ctx.record.index)
    if ctx.trace is None or ctx.trace.kernels == 0 or calls == 0:
        return None
    return ctx.trace.kernels / calls
