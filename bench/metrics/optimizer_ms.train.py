"""Device ms a training step of the kernels launched under the program's
``optim_adamw`` span (``launch/steps.py``: the learning-rate schedule,
the gradients' global norm and clipping, and the AdamW update of every
leaf, ``optim/adamw.py``)."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "train" or not ctx.units:
        return None
    t = ctx.trace.range_s("optim_adamw")
    return None if t is None else 1e3 * t / sum(u["steps"] for u in ctx.units)
