"""Tokens that the window's finished generates returned, over the sum of
their walls (prefill included), timed back to back."""


def read(ctx):
    if ctx.kind != "serve" or ctx.traffic["n_new"] < 2 or not ctx.units:
        return None
    return (sum(u["B"] * u["n_new"] for u in ctx.units)
            / sum(u["wall_s"] for u in ctx.units))
