"""Batch x sequence x steps completed, over the wall of those steps (each
chunk of steps ends in a synchronise)."""


def read(ctx):
    if ctx.kind != "train" or not ctx.units:
        return None
    return (sum(u["steps"] * u["B"] * u["S"] for u in ctx.units)
            / sum(u["wall_s"] for u in ctx.units))
