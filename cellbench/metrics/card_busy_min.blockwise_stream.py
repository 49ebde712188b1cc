"""card_busy_min.blockwise_stream (device layer): the share of the traced
window in which the least busy of the cell's cards ran a kernel, copy or
set (the union of its device intervals); a card with no record reads 0."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.busy_s_by_card:
        return None
    busy = [ctx.trace.busy_s_by_card.get(card.index, 0.0) for card in ctx.cards]
    return 100.0 * min(busy) / ctx.trace.window_s
