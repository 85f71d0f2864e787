"""The flash forward's share of its roofline at prefill, in %: the least
time of its calls (bench/work.py at the cell's shapes: every layer of
every traced request) over the device time of the kernels under the
``repro_torch::flash_fwd`` operator."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "serve" or not ctx.units:
        return None
    t = ctx.trace.op_s("repro_torch::flash_fwd")
    if t <= 0:
        return None
    w, m = ctx.work, ctx.m
    qk, v = w.attn_dims(m)
    KH = m["n_heads"] if m.get("mla") else m["n_kv_heads"]
    least = sum(m["n_layers"] * w.bound_s(*w.flash_fwd_work(
        u["B"], u["S0"], u["S0"], m["n_heads"], KH, qk, v, 2,
        window=m.get("swa_window", 0))) for u in ctx.units)
    return 100 * least / t
