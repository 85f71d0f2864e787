"""The training step's model FLOPs (bench/work.py, from the shapes) over
the traced window's wall, as a share of the bf16 peak, in %."""


def read(ctx):
    if ctx.kind != "train" or not ctx.units:
        return None
    w = ctx.work
    flops = sum(u["steps"] * w.train_step_flops(ctx.m, u["B"], u["S"])
                for u in ctx.units)
    return 100 * flops / sum(u["wall_s"] for u in ctx.units) \
        / w.PEAK_FLOPS_BF16
