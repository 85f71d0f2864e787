"""The card's idle share of the traced window, in %: one minus the union
of its kernel, copy and set intervals over the window."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100 * (1 - ctx.trace.busy_s / ctx.trace.window_s)
