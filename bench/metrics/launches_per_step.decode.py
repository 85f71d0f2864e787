"""Launches a decode step: the host's kernel-launch calls in the traced
generates' decode phases (after the prefill's arg-max), a CUDA graph's
launch counted once, over their decode steps."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "serve" or not ctx.units:
        return None
    steps = sum(u["n_new"] - 1 for u in ctx.units)
    n = ctx.trace.decode_launches()
    return n / steps if steps and n else None
