"""DeepSeek-V2's Multi-head Latent Attention on the CPU against the JAX
package: ``mla_prefill`` (the decompressed attention through the flash op
at a q/k head dim of nope + rope and a v head dim of v_head_dim) and the
absorbed ``mla_decode`` on the same inputs and weights, the plain flash at
MLA's full-width head dims (192, 128) against the JAX jnp flash with its
gradient, the compressed cache's layout, and the guard that keeps a
gradient at (192, 128) off the card until the flash backward kernel takes
those head dims."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models.layers import rope_cos_sin as jax_rope
from repro_torch import interop
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_fwd_ref
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models.layers import rope_cos_sin as torch_rope

ARCH = "deepseek-v2-lite-16b"
# fp32: summation order only; bf16: one rounding (tests/test_kernels.py:110)
TOLS = {"float32": 1e-4, "bfloat16": 5e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(t, j, tol, msg=""):
    np.testing.assert_allclose(_np(t), _np(j), atol=tol, rtol=tol,
                               err_msg=msg)


def _attn_weights(seed=0):
    """Layer 0 of the MoE stack's MLA weights, JAX's and carried over."""
    jcfg, tcfg = jax_smoke(ARCH), torch_smoke(ARCH)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = interop.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    pj = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["attn"])
    pt = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    return jcfg, tcfg, pj, pt


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mla_prefill_matches_jax(compute_dtype):
    jcfg, tcfg, pj, pt = _attn_weights()
    m = tcfg.mla
    B, S = 2, 64
    x = np.random.default_rng(1).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    jdt, tdt = getattr(jnp, compute_dtype), getattr(torch, compute_dtype)
    cj, sj = jax_rope(jnp.arange(S), m.qk_rope_head_dim, jcfg.rope_theta)
    ct, st = torch_rope(torch.arange(S), m.qk_rope_head_dim, tcfg.rope_theta)
    yj, (ckv_j, kr_j) = jattn.mla_prefill(pj, jnp.asarray(x).astype(jdt), cj,
                                          sj, jcfg, jdt)
    yt, (ckv_t, kr_t) = tattn.mla_prefill(pt, torch.from_numpy(x).to(tdt),
                                          ct, st, tcfg, tdt)
    assert yt.dtype == tdt and tuple(yt.shape) == (B, S, tcfg.d_model)
    assert tuple(ckv_t.shape) == (B, S, m.kv_lora_rank)
    assert tuple(kr_t.shape) == (B, S, m.qk_rope_head_dim)
    tol = TOLS[compute_dtype]
    _close(yt, yj, tol, "out")
    _close(ckv_t, ckv_j, tol, "ckv")
    _close(kr_t, kr_j, tol, "k_rope")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax(compute_dtype):
    """Two absorbed decode steps on the same bf16 latent cache (the
    second reads the first's write): outputs and both caches, written in
    place."""
    jcfg, tcfg, pj, pt = _attn_weights(seed=1)
    m = tcfg.mla
    B, Smax, pos = 2, 32, 20
    rng = np.random.default_rng(2)
    ckv = rng.standard_normal((B, Smax, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, Smax, m.qk_rope_head_dim)).astype(
        np.float32)
    ckv_j = jnp.asarray(ckv).astype(jnp.bfloat16)
    kr_j = jnp.asarray(kr).astype(jnp.bfloat16)
    ckv_t = interop._tensor_from_numpy(np.asarray(ckv_j), "cpu")
    kr_t = interop._tensor_from_numpy(np.asarray(kr_j), "cpu")
    jdt, tdt = getattr(jnp, compute_dtype), getattr(torch, compute_dtype)
    tol = TOLS[compute_dtype]
    for step in range(2):
        x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
        p = pos + step
        cj, sj = jax_rope(jnp.asarray([p]), m.qk_rope_head_dim,
                          jcfg.rope_theta)
        ct, st = torch_rope(torch.tensor([p]), m.qk_rope_head_dim,
                            tcfg.rope_theta)
        yj, ckv_j, kr_j = jattn.mla_decode(pj, jnp.asarray(x).astype(jdt),
                                           ckv_j, kr_j, jnp.int32(p), cj, sj,
                                           jcfg, jdt)
        yt, c2, k2 = tattn.mla_decode(pt, torch.from_numpy(x).to(tdt), ckv_t,
                                      kr_t, p, ct, st, tcfg, tdt)
        assert c2 is ckv_t and k2 is kr_t            # written in place
        assert tuple(yt.shape) == (B, 1, tcfg.d_model) and yt.dtype == tdt
        _close(yt, yj, tol, f"out, step {step}")
        _close(ckv_t, ckv_j, TOLS["bfloat16"], f"ckv, step {step}")
        _close(kr_t, kr_j, TOLS["bfloat16"], f"k_rope, step {step}")


def _mla_qkv(rng, B, S, H, hd=192, hdv=128, dtype=np.float32):
    return (rng.standard_normal((B, S, H, hd)).astype(dtype),
            rng.standard_normal((B, S, H, hd)).astype(dtype),
            rng.standard_normal((B, S, H, hdv)).astype(dtype))


@pytest.mark.parametrize("S,q_chunk", [(128, 32), (256, 64)])
def test_plain_flash_at_mla_head_dims_matches_jax(S, q_chunk):
    """The plain flash (what a CPU tensor runs) at q/k 192, v 128 against
    the JAX jnp flash: the output, lse, and the gradient through
    ``FlashAttention``'s plain block-recompute backward against
    ``jax.grad``."""
    rng = np.random.default_rng(3)
    q, k, v = _mla_qkv(rng, 1, S, 4)
    w = rng.standard_normal((1, S, 4, 128)).astype(np.float32)
    scale = 1.0 / math.sqrt(192)

    def jf(q_, k_, v_):
        return jattn.flash_attention(q_, k_, v_, q_chunk=q_chunk, scale=scale)
    yj, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    gj = vjp(jnp.asarray(w))
    _, lse_j, _ = jattn._fwd_blocks(*(jnp.asarray(a) for a in (q, k, v)),
                                    True, 0, q_chunk, q_chunk, scale,
                                    "triangular")
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    yt = flash_ops.flash_attention(tq, tk, tv, scale=scale, q_chunk=q_chunk)
    assert tuple(yt.shape) == (1, S, 4, 128)
    _close(yt, yj, 2e-5, "out")
    _, lse_t = flash_attention_fwd_ref(tq, tk, tv, scale=scale,
                                       q_chunk=q_chunk)
    _close(lse_t, lse_j, 2e-5, "lse")
    (yt * torch.from_numpy(w)).sum().backward()
    for n, a, b in zip("qkv", (tq, tk, tv), gj):
        _close(a.grad, b, 5e-5, f"d{n}")


def test_flash_op_at_mla_head_dims_guards_the_card(monkeypatch):
    """On a tensor that is not on the CPU (here ``meta``: no card needed),
    a flash call at q/k 192, v 128 goes to the forward kernel's wrapper
    (which takes CUDA tensors only, and raises for anything else), with a
    gradient as without one: the backward kernel takes those head dims
    too, so no guard stops it first. At equal head dims the same."""
    meta = torch.device("meta")
    calls = []
    real = flash_ops.flash_attention_fwd
    monkeypatch.setattr(flash_ops, "flash_attention_fwd",
                        lambda *a, **kw: calls.append(a[2].shape[-1])
                        or real(*a, **kw))
    q = torch.empty((1, 64, 2, 192), device=meta, requires_grad=True)
    k = torch.empty((1, 64, 2, 192), device=meta)
    v = torch.empty((1, 64, 2, 128), device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        flash_ops.flash_attention(q, k, v)
    assert calls == [128]
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        flash_ops.flash_attention(q, k, v)
    assert calls == [128, 128]
    q64 = torch.empty((1, 64, 2, 128), device=meta, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_ops.flash_attention(q64, q64.detach(), v)
    assert calls == [128, 128, 128]


def test_mla_cache_layout():
    """A compressed cache: ckv (L, B, S, lora) and kr (L, B, S, rope) in
    bf16 for all L layers, dense ones first; read by no paged op, so any
    length; a decode position outside it raises."""
    cfg = torch_smoke(ARCH)
    m = cfg.mla
    c = tlm.init_cache(cfg, 36, 2, device="cpu")
    assert set(c) == {"ckv", "kr"}
    assert c["ckv"].shape == (cfg.n_layers, 2, 36, m.kv_lora_rank)
    assert c["kr"].shape == (cfg.n_layers, 2, 36, m.qk_rope_head_dim)
    assert c["ckv"].dtype == c["kr"].dtype == torch.bfloat16
    j = jlm.cache_spec_defs(jax_smoke(ARCH), 36, 2)
    assert {n: d.shape for n, d in j.items()} == \
        {n: tuple(t.shape) for n, t in c.items()}
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    with pytest.raises(ValueError, match="outside the cache"):
        tlm.decode_step(cfg, params, c, torch.zeros((2, 1),
                                                    dtype=torch.int32), 36)
    grown = tlm.grow_cache(cfg, {n: t[:, :, :20] + 1 for n, t in c.items()},
                           48)
    assert grown["ckv"].shape[2] == 48
    assert bool((grown["ckv"][:, :, :20] == 1).all())
    assert not bool(grown["ckv"][:, :, 20:].any())
