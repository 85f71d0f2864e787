"""Time to first token, 95th percentile over every request of the
window (one prompt, a one-token answer): from the call of the serving
loop until the token is on the host, in ms."""

import numpy as np


def read(ctx):
    if ctx.kind != "serve" or ctx.traffic["n_new"] != 1 or not ctx.units:
        return None
    return float(np.percentile([1e3 * u["wall_s"] for u in ctx.units], 95))
