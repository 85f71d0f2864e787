"""The port's layers against ``repro.models.layers`` in fp32, on the same
numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = 1e-6


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=tol, rtol=tol)


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 5, 48), _rand(rng, 48)
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("hd,theta", [(24, 10_000.0), (64, 1_000_000.0)])
def test_rope_matches(hd, theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, hd)
    pos = np.arange(100, 107, dtype=np.int32)
    tc, ts = tl.rope_cos_sin(torch.from_numpy(pos), hd, theta)
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), hd, theta)
    _close(tc, jc)
    _close(ts, js)
    _close(tl.apply_rope(torch.from_numpy(x), tc, ts),
           jl.apply_rope(jnp.asarray(x), jc, js))


def test_swiglu_and_gelu_match():
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 5, 16)
    w1, w3 = _rand(rng, 16, 40, scale=0.25), _rand(rng, 16, 40, scale=0.25)
    w2 = _rand(rng, 40, 16, scale=0.15)
    T = torch.from_numpy
    _close(tl.swiglu(T(x), T(w1), T(w3), T(w2), torch.float32),
           jl.swiglu(jnp.asarray(x), w1, w3, w2, jnp.float32))
    _close(tl.gelu_mlp(T(x), T(w1), T(w2), torch.float32),
           jl.gelu_mlp(jnp.asarray(x), w1, w2, jnp.float32))


def test_param_defs_and_padded_vocab_match():
    from repro.configs import get_smoke_config
    for v in (384, 640, 100352, 50280):
        assert tl.padded_vocab(v) == jl.padded_vocab(v)
    cfg = get_smoke_config("stablelm-1.6b")
    j = jl.mlp_defs(cfg, cfg.d_ff, ll=(2,))
    t = tl.mlp_defs(cfg, cfg.d_ff, ll=(2,))
    assert {k: (d.shape, d.logical, d.init) for k, d in t.items()} == \
        {k: (d.shape, d.logical, d.init) for k, d in j.items()}


def test_materialize_is_seeded_and_scaled():
    defs = {"w": tl.ParamDef((256, 64), (None, None)),
            "n": tl.ParamDef((64,), (None,), init="ones")}
    a = tl.materialize(defs, torch.Generator().manual_seed(3), device="cpu")
    b = tl.materialize(defs, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a["w"], b["w"]) and torch.equal(a["n"],
                                                       torch.ones(64))
    assert abs(a["w"].std().item() - 1 / 16) < 0.005    # 1/sqrt(fan_in)
