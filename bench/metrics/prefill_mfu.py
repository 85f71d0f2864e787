"""The prefills' model FLOPs (bench/work.py: the head at the last
position only) over the traced requests' walls, as a share of the bf16
peak, in %."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.units:
        return None
    w = ctx.work
    flops = sum(w.prefill_flops(ctx.m, u["B"], u["S0"]) for u in ctx.units)
    return 100 * flops / sum(u["wall_s"] for u in ctx.units) \
        / w.PEAK_FLOPS_BF16
