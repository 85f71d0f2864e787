"""Device ms a training step of the kernels under the MoE layer's
``moe_dispatch`` range (forward and its recomputation; the backward of
the scatter runs outside the range)."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "train" or not ctx.units:
        return None
    t = ctx.trace.range_s("moe_dispatch")
    return None if t is None else 1e3 * t / sum(u["steps"] for u in ctx.units)
