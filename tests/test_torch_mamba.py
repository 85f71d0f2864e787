"""The port's Mamba2 block against the JAX package on the CPU, with JAX
weights carried over through numpy: the causal conv, the single-token SSD
recurrence and the whole block (from scratch, and continuing a sequence
from carried states as decode does)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import lm as jlm
from repro.models import mamba as jmamba
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import mamba as tmamba

ARCHS = ["mamba2-130m", "zamba2-2.7b"]
# fp32: summation order only; bf16: one bf16 ulp of the block output
TOLS = {"float32": 1e-4, "bfloat16": 3e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(t, j, tol, msg=""):
    np.testing.assert_allclose(_np(t), _np(j), atol=tol, rtol=tol,
                               err_msg=msg)


def _both(a, dtype):
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _layer0(arch, compute_dtype, seed=0):
    jcfg = jax_smoke(arch).replace(compute_dtype=compute_dtype)
    tcfg = torch_smoke(arch).replace(compute_dtype=compute_dtype)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    tl = {k: torch.from_numpy(np.array(v)) for k, v in jl.items()}
    return jcfg, tcfg, jl, tl


def test_mamba_defs_match_jax():
    for arch in ARCHS:
        jd = jmamba.mamba_defs(jax_smoke(arch), ll=(3,))
        td = tmamba.mamba_defs(torch_smoke(arch), ll=(3,))
        assert list(jd) == list(td)
        for k in jd:
            assert (jd[k].shape, jd[k].logical, jd[k].init, jd[k].scale) == \
                (td[k].shape, td[k].logical, td[k].init, td[k].scale), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(dtype, with_state):
    rng = np.random.default_rng(0)
    u = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = (rng.standard_normal((4, 24)) * 0.5).astype(np.float32)
    ju, tu = _both(u, dtype)
    jw, tw = _both(w, dtype)
    js = ts = None
    if with_state:       # the cache keeps conv states in bf16
        js, ts = _both(rng.standard_normal((2, 3, 24)).astype(np.float32),
                       "bfloat16")
    jy, jst = jmamba.causal_conv(ju, jw, js)
    ty, tst = tmamba.causal_conv(tu, tw, ts)
    assert ty.dtype == getattr(torch, str(jy.dtype))
    assert tst.dtype == getattr(torch, str(jst.dtype))
    _close(ty, jy, TOLS[dtype], "y")
    np.testing.assert_array_equal(_np(tst), _np(jst))


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(1)
    B, nh, hp, ns = 2, 4, 16, 8
    f = np.float32
    x = (rng.standard_normal((B, nh, hp)) * 0.5).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((B, nh)))).astype(f)
    A_log = (rng.standard_normal(nh) * 0.3).astype(f)
    Bv = (rng.standard_normal((B, ns)) * 0.5).astype(f)
    Cv = (rng.standard_normal((B, ns)) * 0.5).astype(f)
    D = np.ones(nh, f)
    st = (rng.standard_normal((B, nh, hp, ns)) * 0.2).astype(f)
    args = [x, dt, A_log, Bv, Cv, D, st]
    jy, jst = jmamba.ssd_decode_step(*[jnp.asarray(a) for a in args])
    ty, tst = tmamba.ssd_decode_step(*[torch.from_numpy(a) for a in args])
    _close(ty, jy, 1e-5, "y")
    _close(tst, jst, 1e-5, "state")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_block_matches_jax(arch, compute_dtype):
    """A 40-token block (two chunks of 32 with padding), then one token
    continuing from the returned SSM and conv states (a decode step)."""
    jcfg, tcfg, jl, tl = _layer0(arch, compute_dtype)
    dt = compute_dtype
    rng = np.random.default_rng(2)
    u = (rng.standard_normal((2, 40, jcfg.d_model)) * 0.5).astype(np.float32)
    ju, tu = _both(u, dt)
    jout, jst, jconv = jmamba.mamba_block(jcfg, jl, ju, jnp.dtype(dt),
                                          return_state=True)
    tout, tst, tconv = tmamba.mamba_block(tcfg, tl, tu, getattr(torch, dt),
                                          return_state=True)
    tol = TOLS[dt]
    assert tout.dtype == getattr(torch, dt) and tst.dtype == torch.float32
    _close(tout, jout, tol, "out")
    _close(tst, jst, tol, "ssm state")
    for n, a, b in zip(("conv_x", "conv_b", "conv_c"), tconv, jconv):
        _close(a, b, tol, n)

    # decode: one more token from the carried states (conv states in bf16)
    u1 = (rng.standard_normal((2, 1, jcfg.d_model)) * 0.5).astype(np.float32)
    ju1, tu1 = _both(u1, dt)
    jc = tuple(c.astype(jnp.bfloat16) for c in jconv)
    tc = tuple(torch.from_numpy(np.array(c.astype(jnp.float32)))
               .to(torch.bfloat16) for c in jc)
    jout1, jst1, _ = jmamba.mamba_decode_block(jcfg, jl, ju1, jst, jc,
                                               jnp.dtype(dt))
    tout1, tst1, _ = tmamba.mamba_decode_block(
        tcfg, tl, tu1, torch.from_numpy(np.array(jst)), tc,
        getattr(torch, dt))
    _close(tout1, jout1, tol, "decode out")
    _close(tst1, jst1, tol, "decode ssm state")
