"""The port's flash attention gradient on the CPU: ``FlashAttention`` (the
plain forward with its lse and the plain block-recompute backward, which
the CUDA kernels replace on a card) against ``jax.grad`` of the JAX
package's ``flash_attention`` (its custom VJP), on the same numpy inputs;
plus the gradient guards of the ops whose kernels have no backward. The
CUDA backward kernel is held against the plain backward on a card by
tests/test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _fwd_blocks as jax_fwd_blocks
from repro.models.attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_ref,
                                                     reference_attention)
from repro_torch.kernels.paged_attn import ops as paged_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import attention as tattn

# tests/test_models.py::test_flash_gradients_match_reference
GRAD_TOL = 5e-5


def _inputs(seed, B, S, H, KH, hd, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sk or S
    q = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, Sk, KH, hd), dtype=np.float32)
    v = rng.standard_normal((B, Sk, KH, hd), dtype=np.float32)
    w = rng.standard_normal((B, S, H, hd), dtype=np.float32)   # d loss / d o
    return q, k, v, w


@pytest.mark.parametrize("schedule", ["rect", "triangular"])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("kv_heads", [4, 1], ids=["mha", "gqa"])
def test_flash_gradients_match_jax(schedule, window, kv_heads):
    """Twin of test_models.py::test_flash_gradients_match_reference, over
    both schedules, a sliding window and GQA (4 query heads on 1 KV
    head); the loss weights each output element differently."""
    q, k, v, w = _inputs(3, 2, 128, 4, kv_heads, 16)
    f = lambda *a: (jax_flash(*a, window=window, q_chunk=32,
                              schedule=schedule) * w).sum()
    gj = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, window=window, q_chunk=32,
                                schedule=schedule)
    (out * torch.from_numpy(w)).sum().backward()
    for name, a, b in zip("qkv", gj, (tq.grad, tk.grad, tv.grad)):
        assert b.shape == a.shape, name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("schedule", ["rect", "triangular"])
def test_lse_matches_jax_fwd_blocks(schedule):
    """The plain forward's lse (B, H, S) is the JAX ``_fwd_blocks`` lse:
    natural log of the softmax denominator of the scaled scores."""
    q, k, v, _ = _inputs(4, 2, 128, 4, 2, 16)
    kr, vr = np.repeat(k, 2, axis=2), np.repeat(v, 2, axis=2)
    yj, lj, _ = jax_fwd_blocks(jnp.asarray(q), jnp.asarray(kr),
                               jnp.asarray(vr), True, 48, 32, 32, 0.25,
                               schedule)
    yt, lt = flash_attention_fwd_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), window=48, scale=0.25,
        q_chunk=32, schedule=schedule)
    assert lt.shape == (2, 4, 128) and lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("S,window", [(100, 0), (100, 20), (130, 0)])
def test_plain_backward_matches_autograd_of_reference(S, window):
    """Ragged last chunks (the kernels take any S): the plain backward
    against autograd of the O(S²) oracle, GQA 4 on 2."""
    q, k, v, w = (torch.from_numpy(a) for a in _inputs(5, 1, S, 4, 2, 32))
    o, lse = flash_attention_fwd_ref(q, k, v, window=window, q_chunk=32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = reference_attention(*leaves, window=window)
    np.testing.assert_allclose(o.numpy(), ref.detach().numpy(), atol=2e-5,
                               rtol=2e-5)
    ref.backward(w)
    got = flash_attention_bwd_ref(q, k, v, o, lse, w, window=window,
                                  q_chunk=32)
    for name, a, b in zip("qkv", got, leaves):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"d{name}")


def test_backward_saves_unrepeated_kv():
    """GQA is summed inside the backward: the forward saves k/v as they
    are (KH heads), never an H-head repeated copy."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(6, 1, 64, 8, 2, 16))
    shapes = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
        out = flash_ops.flash_attention(q.requires_grad_(),
                                        k.requires_grad_(),
                                        v.requires_grad_(), q_chunk=32)
    # q and o with 8 heads, k and v with 2, lse (B, H, S)
    assert sorted(shapes) == sorted([(1, 64, 8, 16)] * 2
                                    + [(1, 64, 2, 16)] * 2 + [(1, 8, 64)])
    out.sum().backward()
    assert k.grad.shape == k.shape and v.grad.shape == v.shape


def test_no_grad_forward_matches_grad_forward():
    """The same output with and without autograd recording."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(7, 2, 64, 4, 2, 16))
    with torch.inference_mode():
        a = tattn.flash_attention(q, k, v, q_chunk=32)
    b = tattn.flash_attention(q.clone().requires_grad_(), k, v, q_chunk=32)
    assert torch.equal(a, b.detach())


def test_ops_without_a_backward_raise_when_a_gradient_is_needed():
    """On a tensor that is not on the CPU (here the ``meta`` device, so no
    card is needed), the SSD and paged ops refuse a call that autograd
    would differentiate, rather than return a tensor that drops the
    gradient; without a gradient they go on to their kernels."""
    meta = torch.device("meta")
    x = torch.empty((1, 8, 2, 16), device=meta, requires_grad=True)
    dt = torch.empty((1, 8, 2), device=meta)
    A_log, D = torch.empty(2, device=meta), torch.empty(2, device=meta)
    Bm = torch.empty((1, 8, 4), device=meta)
    with pytest.raises(NotImplementedError, match="SSD backward"):
        ssd_ops.ssd(x, dt, A_log, Bm, Bm, D, chunk=8)
    q = torch.empty((1, 2, 16), device=meta, requires_grad=True)
    pool = torch.empty((2, 16, 2, 16), device=meta)
    table = torch.zeros((1, 2), dtype=torch.int32, device=meta)
    lens = torch.zeros((1,), dtype=torch.int32, device=meta)
    with pytest.raises(NotImplementedError, match="no backward"):
        paged_ops.paged_attention(q, pool, pool, table, lens)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        paged_ops.paged_attention(q, pool, pool, table, lens)
    # the CPU path differentiates through the plain versions
    xc = torch.randn((1, 8, 2, 16), requires_grad=True)
    y, _ = ssd_ops.ssd(xc, torch.rand((1, 8, 2)), torch.zeros(2),
                       torch.randn((1, 8, 4)), torch.randn((1, 8, 4)),
                       torch.ones(2), chunk=4)
    y.sum().backward()
    assert xc.grad is not None and torch.isfinite(xc.grad).all()
