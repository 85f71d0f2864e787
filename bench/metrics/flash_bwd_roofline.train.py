"""The flash backward's share of its roofline in training, in %: the
least time of its calls (bench/work.py: every layer of every traced
step) over the device time of the kernels under the
``repro_torch::flash_bwd`` operator."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "train" or not ctx.units:
        return None
    t = ctx.trace.op_s("repro_torch::flash_bwd")
    if t <= 0:
        return None
    w, m = ctx.work, ctx.m
    qk, v = w.attn_dims(m)
    KH = m["n_heads"] if m.get("mla") else m["n_kv_heads"]
    least = sum(u["steps"] * m["n_layers"] * w.bound_s(*w.flash_bwd_work(
        u["B"], u["S"], u["S"], m["n_heads"], KH, qk, v, 2,
        window=m.get("swa_window", 0))) for u in ctx.units)
    return 100 * least / t
