"""Device ms a decode step of the kernels under the MoE layer's
``moe_experts`` range, in the decode phase of the traced generates."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "serve" or not ctx.units:
        return None
    steps = sum(u["n_new"] - 1 for u in ctx.units)
    t = ctx.trace.range_s("moe_experts", "decode")
    return None if t is None or not steps else 1e3 * t / steps
