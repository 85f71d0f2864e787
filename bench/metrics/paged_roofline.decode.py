"""The paged decode kernel's share of its roofline, in %: the least time
of its calls (bench/work.py: every layer of every decode step of the
traced generates, each row reading the positions it holds) over the
device time of the kernels under ``repro_torch::paged_attention``."""

PAGE = 16


def read(ctx):
    m = ctx.m
    if ctx.trace is None or ctx.kind != "serve" or m.get("mla") \
            or not ctx.units:
        return None
    t = ctx.trace.op_s("repro_torch::paged_attention")
    if t <= 0:
        return None
    w = ctx.work
    least = 0.0
    for u in ctx.units:
        for j in range(u["n_new"] - 1):
            n = u["S0"] + j + 1
            least += m["n_layers"] * w.bound_s(*w.paged_work(
                u["B"], m["n_heads"], m["n_kv_heads"], m["head_dim"], n,
                -(-n // PAGE), 2))
    return 100 * least / t
