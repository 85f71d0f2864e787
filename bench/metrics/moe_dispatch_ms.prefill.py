"""Device ms a request of the kernels under the MoE layer's
``moe_dispatch`` range (the slot scan and the scatter), prefill."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "serve" or not ctx.units:
        return None
    t = ctx.trace.range_s("moe_dispatch")
    return None if t is None else 1e3 * t / len(ctx.units)
