"""The card's idle share of the traced slice, in percent: 1 - the union of
its kernel, copy and set intervals over the slice's length."""


def read(ctx):
    if ctx.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.slice.busy_s / ctx.slice.window_s)
