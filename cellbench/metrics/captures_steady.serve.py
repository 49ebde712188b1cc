"""captures_steady.serve (engine dispatch layer): programs the engine
built (on one card, each a captured CUDA graph) after set-up's warm-up,
by its own counter. Expected 0."""


def read(ctx):
    if "builds" not in ctx.counters_end:
        return None
    return ctx.counters_end["builds"] - ctx.counters_warm["builds"]
