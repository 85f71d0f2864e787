"""The gradient of the port's SSD on the CPU, on numpy inputs:

* ``ssd_chunk_bwd_ref`` (the explicit backward of the four chunk pieces,
  the yardstick of the CUDA backward kernel) against autograd of
  ``ssd_chunk_ref`` in fp64, and against the VJP of the JAX package's
  pieces (``repro.kernels.ssd_scan.kernel.ssd_chunk_call`` in interpret
  mode, as tests/test_kernels.py runs it; Pallas has no reverse-mode rule,
  so each entry of the VJP is a ``jax.jvp`` along one input direction,
  dotted with the same cotangents);
* ``ssd_chunk_bwd_split_ref`` (the split bf16 arithmetic of the
  kernel's tensor-core instance) the same ways, on bf16 x/B/C; what one
  piece fewer costs against the kernel's tolerance; and, by hypothesis,
  the kernel's rule for head groups and tile pairs;
* the gradient of the full ``ops.ssd`` (``SSDChunk`` + the inter-chunk
  recurrence; an initial state, a padded S) against ``jax.grad`` of the
  JAX ``ssd_chunked``, and, over hypothesis-drawn (cl, hp, ns, S mod cl),
  against autograd of the port's plain ``ssd_chunked`` (dA_log, a sum
  over every token whose terms cancel, is held relative to the size of
  its terms).

The CUDA kernel is held against ``ssd_chunk_bwd_ref`` and the split
twin on a card by tests/test_torch_gpu.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.ssd_scan.kernel import ssd_chunk_call as pk_chunk
from repro.models.mamba import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (BWD_GROUP, BWD_PIECES,
                                              bwd_head_groups,
                                              bwd_tile_pairs,
                                              ssd_chunk_bwd_ref,
                                              ssd_chunk_bwd_split_ref,
                                              ssd_chunk_ref)
from repro_torch.models import mamba as tmamba

GRADS = ("dx", "ddt", "dA_log", "dB", "dC")
# fp32 explicit backward vs fp64 autograd: fp32 rounding of sums of up to
# cl terms (measured <= 6e-7 of each gradient's largest element)
FP32_TOL = 1e-5
# fp64 explicit backward vs fp64 autograd: the same formulas
FP64_TOL = 1e-10
# vs JAX: the JAX package sums cs = cumsum(dt A) in fp32, the port in fp64
# (ROADMAP Queue 3), which moves L and the decays by ~1e-6 relative at
# these chunk lengths
JAX_TOL = 1e-4
# (B, S, nh, hp, ns, cl): the smoke configs' head shape, a chunk that is
# not a multiple of 16, one chunk, several heads of 8
BWD_SHAPES = [(2, 64, 3, 32, 16, 32), (1, 96, 2, 16, 8, 48),
              (1, 40, 2, 8, 4, 40), (2, 48, 4, 8, 12, 16)]
# small enough for a Jacobian through the interpret-mode Pallas kernel
JAX_SHAPES = [(1, 16, 2, 8, 4, 8), (2, 12, 2, 4, 8, 6)]
# the full op: padded S with an initial state (smoke hp/ns/cl), one chunk
FULL_SHAPES = [(2, 100, 4, 32, 16, 32), (1, 64, 2, 16, 8, 32),
               (1, 30, 3, 8, 4, 64)]
# slow decay: dt scaled by SLOW_DT makes dt·A about -0.008 a token (not
# -0.8), so exp(tot), w_j across the chunk and L far below the diagonal are
# 0.1 to 1 at cl 200 and 256 and weigh as much as the other terms
SLOW_DT = 0.01
SLOW_SHAPES = [(1, 200, 2, 16, 8, 200), (1, 512, 2, 8, 4, 256)]
# the split twin (the bf16 kernel's arithmetic) returns dx, dB and dC in
# bf16: those may also sit one bf16 ulp (2^-7 relative) from the yardstick
BF16_ULP = 2.0 ** -7
# the card checks' tolerance for the backward kernel (chip_smoke.py
# SSD_BWD_TOL): 1e-4 of each gradient's scale (dA_log: of Σ |ddt| dt)
KERNEL_TOL = 1e-4


def _inputs(B, S, nh, hp, ns, seed=0, dt_scale=1.0):
    """tests/test_kernels.py's SSD distributions, dt times ``dt_scale``,
    from numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return [(rng.standard_normal((B, S, nh, hp)) * 0.5).astype(f),
            (np.log1p(np.exp(rng.standard_normal((B, S, nh))))
             * dt_scale).astype(f),
            (rng.standard_normal(nh) * 0.3).astype(f),
            (rng.standard_normal((B, S, ns)) * 0.5).astype(f),
            (rng.standard_normal((B, S, ns)) * 0.5).astype(f)]


def _cotangents(B, S, nh, hp, ns, cl, seed=1):
    """Random nonzero cotangents of the four pieces."""
    rng = np.random.default_rng(seed)
    nc = S // cl
    return [rng.standard_normal(shape).astype(np.float32) for shape in (
        (B, nc, cl, nh, hp), (B, nc, nh, hp, ns), (B, nc, cl, nh),
        (B, nc, nh))]


def _assert_scaled(got, want, tol, what):
    for name, a, b in zip(GRADS, got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (what, name)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * np.abs(b).max(),
                                   err_msg=f"{what} {name}")


def _autograd_pieces(arrs, cots, cl, dtype):
    ins = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrs]
    out = ssd_chunk_ref(*ins, chunk=cl)
    return torch.autograd.grad(out, ins, [torch.from_numpy(c).to(dtype)
                                          for c in cots])


@pytest.mark.parametrize("B,S,nh,hp,ns,cl", BWD_SHAPES)
def test_chunk_backward_matches_fp64_autograd(B, S, nh, hp, ns, cl):
    """In fp64 the explicit formulas equal autograd of the pieces; in fp32
    (what the kernel computes) they are within FP32_TOL of it."""
    arrs = _inputs(B, S, nh, hp, ns)
    cots = _cotangents(B, S, nh, hp, ns, cl)
    want = _autograd_pieces(arrs, cots, cl, torch.float64)
    got64 = ssd_chunk_bwd_ref(*(torch.from_numpy(a).double() for a in arrs),
                              *(torch.from_numpy(c).double() for c in cots),
                              chunk=cl)
    _assert_scaled(got64, want, FP64_TOL, "fp64")
    got = ssd_chunk_bwd_ref(*map(torch.from_numpy, arrs + cots), chunk=cl)
    for name, g in zip(GRADS, got):
        assert g.dtype == torch.float32, name
    _assert_scaled(got, want, FP32_TOL, "fp32")


@pytest.mark.parametrize("B,S,nh,hp,ns,cl", SLOW_SHAPES)
def test_chunk_backward_slow_decay_matches_fp64_autograd(B, S, nh, hp, ns,
                                                         cl):
    """With slow decay (exp(tot) of 0.1 or more), the explicit backward in
    fp64 and in fp32 against fp64 autograd of the pieces, as above."""
    arrs = _inputs(B, S, nh, hp, ns, seed=5, dt_scale=SLOW_DT)
    tot = arrs[1].reshape(B, S // cl, cl, nh).sum(2) * -np.exp(arrs[2])
    assert np.exp(tot).mean() > 0.05
    cots = _cotangents(B, S, nh, hp, ns, cl, seed=6)
    want = _autograd_pieces(arrs, cots, cl, torch.float64)
    got64 = ssd_chunk_bwd_ref(*(torch.from_numpy(a).double() for a in arrs),
                              *(torch.from_numpy(c).double() for c in cots),
                              chunk=cl)
    _assert_scaled(got64, want, FP64_TOL, "fp64")
    got = ssd_chunk_bwd_ref(*map(torch.from_numpy, arrs + cots), chunk=cl)
    _assert_scaled(got, want, FP32_TOL, "fp32")


def test_chunk_backward_keeps_input_dtypes():
    """dx, dB and dC come back in the inputs' dtype, ddt and dA_log fp32."""
    arrs = _inputs(1, 32, 2, 8, 4)
    ins = [torch.from_numpy(a) for a in arrs]
    for i in (0, 3, 4):
        ins[i] = ins[i].to(torch.bfloat16)
    got = ssd_chunk_bwd_ref(*ins, *map(torch.from_numpy,
                                       _cotangents(1, 32, 2, 8, 4, 16)),
                            chunk=16)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]


def _jax_pieces_vjp(arrs, cots, cl):
    """The VJP of the Pallas pieces (interpret mode) at ``arrs``, entry by
    entry: the cotangents dotted with ``jax.jvp`` along each input."""
    sizes = [a.size for a in arrs]
    cot = jnp.concatenate([jnp.asarray(c).reshape(-1) for c in cots])
    point = jnp.concatenate([jnp.asarray(a).reshape(-1) for a in arrs])

    def pieces(flat):                        # every input in one vector
        parts = jnp.split(flat, np.cumsum(sizes)[:-1])
        out = pk_chunk(*(p.reshape(a.shape) for p, a in zip(parts, arrs)),
                       chunk=cl, interpret=True)
        return jnp.concatenate([o.reshape(-1) for o in out])

    def entry(e):                            # (Jᵀ c)_k = c · J e_k
        return jnp.dot(cot, jax.jvp(pieces, (point,), (e,))[1])
    flat = np.asarray(jax.jit(lambda eye: jax.lax.map(entry, eye))(
        jnp.eye(point.size, dtype=jnp.float32)))
    return [g.reshape(a.shape) for g, a in
            zip(np.split(flat, np.cumsum(sizes)[:-1]), arrs)]


@pytest.mark.parametrize("B,S,nh,hp,ns,cl", JAX_SHAPES)
def test_chunk_backward_matches_jax_pieces(B, S, nh, hp, ns, cl):
    """Against the VJP of the Pallas pieces (interpret mode), entry by
    entry: the cotangents dotted with ``jax.jvp`` along each input."""
    arrs = _inputs(B, S, nh, hp, ns, seed=3)
    cots = _cotangents(B, S, nh, hp, ns, cl, seed=4)
    want = _jax_pieces_vjp(arrs, cots, cl)
    got = ssd_chunk_bwd_ref(*map(torch.from_numpy, arrs + cots), chunk=cl)
    _assert_scaled(got, want, JAX_TOL, "vs jax pieces")


def _bf16_case(arrs):
    """x, B and C rounded to bf16 values (the bf16 instance's inputs): as
    fp32 arrays for JAX and fp64 autograd, and as torch tensors with x, B
    and C in bf16 for the twin."""
    rounded = [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
               if i in (0, 3, 4) else a for i, a in enumerate(arrs)]
    tensors = [torch.from_numpy(a).to(torch.bfloat16) if i in (0, 3, 4)
               else torch.from_numpy(a) for i, a in enumerate(rounded)]
    return rounded, tensors


def _assert_twin(got, want, tol, what):
    """``_assert_scaled``, with one bf16 ulp more for bf16 outputs."""
    for name, a, b in zip(GRADS, got, want):
        a64 = a.double().numpy() if isinstance(a, torch.Tensor) else a
        b64 = np.asarray(b, np.float64)
        assert a64.shape == b64.shape, (what, name)
        rtol = BF16_ULP if a.dtype == torch.bfloat16 else 0.0
        np.testing.assert_allclose(a64, b64, rtol=rtol,
                                   atol=tol * np.abs(b64).max(),
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("B,S,nh,hp,ns,cl,dt_scale",
                         [s + (1.0,) for s in BWD_SHAPES]
                         + [s + (SLOW_DT,) for s in SLOW_SHAPES])
def test_split_twin_matches_fp64_autograd(B, S, nh, hp, ns, cl, dt_scale):
    """The split arithmetic of the bf16 backward kernel
    (ssd_chunk_bwd_split_ref, its default pieces) on bf16 x/B/C against
    fp64 autograd of the pieces on the same values, fast and slow decay,
    to FP32_TOL, as the fp32 explicit backward is held."""
    arrs, tens = _bf16_case(_inputs(B, S, nh, hp, ns, seed=7,
                                    dt_scale=dt_scale))
    cots = _cotangents(B, S, nh, hp, ns, cl, seed=8)
    want = _autograd_pieces(arrs, cots, cl, torch.float64)
    got = ssd_chunk_bwd_split_ref(*tens, *map(torch.from_numpy, cots),
                                  chunk=cl)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    _assert_twin(got, want, FP32_TOL, f"twin dt x{dt_scale}")


@pytest.mark.parametrize("B,S,nh,hp,ns,cl", JAX_SHAPES)
def test_split_twin_matches_jax_pieces(B, S, nh, hp, ns, cl):
    """The split twin against the VJP of the Pallas pieces (interpret
    mode) on the same bf16-valued inputs, to JAX_TOL."""
    arrs, tens = _bf16_case(_inputs(B, S, nh, hp, ns, seed=3))
    cots = _cotangents(B, S, nh, hp, ns, cl, seed=4)
    want = _jax_pieces_vjp(arrs, cots, cl)
    got = ssd_chunk_bwd_split_ref(*tens, *map(torch.from_numpy, cots),
                                  chunk=cl)
    _assert_twin(got, want, JAX_TOL, "twin vs jax pieces")


def _twin_margin(pieces, dt_scale):
    """Of each gradient, the split twin's largest error beyond one bf16
    ulp over KERNEL_TOL times its scale, against fp64 autograd: the share
    of the kernel's tolerance the split uses (cl 256, 3 heads, hp 64,
    ns 64)."""
    B, S, nh, hp, ns, cl = 1, 512, 3, 64, 64, 256
    arrs, tens = _bf16_case(_inputs(B, S, nh, hp, ns, seed=11,
                                    dt_scale=dt_scale))
    cots = _cotangents(B, S, nh, hp, ns, cl, seed=12)
    want = [w.numpy() for w in _autograd_pieces(arrs, cots, cl,
                                                torch.float64)]
    got = ssd_chunk_bwd_split_ref(*tens, *map(torch.from_numpy, cots),
                                  chunk=cl, pieces=pieces)
    scales = _scales(want, arrs[1])
    out = []
    for a, b, scale in zip(got, want, scales):
        err = np.abs(a.double().numpy() - b)
        if a.dtype == torch.bfloat16:
            err = np.maximum(err - BF16_ULP * np.abs(b), 0.0)
        out.append(float(err.max()) / (KERNEL_TOL * scale))
    return out


@pytest.mark.parametrize("fewer", [(1, BWD_PIECES[1]),
                                   (BWD_PIECES[0], BWD_PIECES[1] - 1)])
def test_fewer_bwd_pieces_lose_the_margin(fewer):
    """Why the backward's pieces are (2, 3): at cl 256, fast and slow
    decay, the kernel's split uses under 5% of its tolerance on every
    gradient. One piece beside the exact operands misses the tolerance
    (dx, ddt, dB, dC); two pieces on Pᵀ·dy leave dx an error beyond its
    bf16 rounding over four times larger, and at slow decay use over four
    times as much of the tolerance on ddt."""
    for dt_scale in (1.0, SLOW_DT):
        mine = _twin_margin(BWD_PIECES, dt_scale)
        assert max(mine) < 0.05, (dt_scale, mine)
        less = _twin_margin(fewer, dt_scale)
        if fewer[0] == 1:
            assert max(less) > 2, (dt_scale, less)
        else:
            assert less[0] > 4 * mine[0], (dt_scale, less, mine)
            if dt_scale == SLOW_DT:
                assert less[1] > 4 * mine[1], (dt_scale, less, mine)


@settings(max_examples=60, deadline=None)
@given(nh=st.integers(1, 200), cl=st.integers(1, 256))
def test_bwd_head_groups_and_tile_pairs(nh, cl):
    """The backward kernel's rule for head groups (runs of BWD_GROUP
    heads in order, only the last ragged) and tile pairs (every (row,
    key) with key <= row < cl in exactly one pair, indexed it (it + 1) / 2
    + jt with jt <= it, the last tile ragged)."""
    groups = bwd_head_groups(nh)
    assert [h for g in groups for h in g] == list(range(nh))
    assert all(len(g) == BWD_GROUP for g in groups[:-1])
    assert 1 <= len(groups[-1]) <= BWD_GROUP
    pairs = bwd_tile_pairs(cl)
    n_kt = -(-cl // 64)
    assert [p[0] for p in pairs] == list(range(n_kt * (n_kt + 1) // 2))
    cover = np.zeros((cl, cl), np.int64)
    for _, it, jt, rows, keys in pairs:
        assert jt <= it < n_kt and 1 <= rows <= 64 and 1 <= keys <= 64
        assert rows == min(64, cl - 64 * it) and keys == min(64, cl - 64 * jt)
        cover[64 * it:64 * it + rows, 64 * jt:64 * jt + keys] += 1
    lower = np.tril(np.ones((cl, cl), np.int64))
    assert (cover[lower == 1] == 1).all()
    assert (cover[np.triu(np.ones((cl, cl), bool), 1)] <= 1).all()


def _jax_ssd_grads(arrs, D, st0, wy, ws, cl):
    def loss(x, dt, A_log, B_, C_, state):
        y, st = jax_ssd_chunked(x, dt, A_log, B_, C_, jnp.asarray(D), cl,
                                state=state, return_state=True)
        return jnp.sum(y * wy) + jnp.sum(st * ws)
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5))(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(st0))


def _scales(grads, dt):
    """What each tolerance of the full op's gradients is relative to: the
    gradient's largest element, but for dA_log, a sum over every token of
    terms the size of ddt·dt that cancel, the sum of those terms' sizes."""
    out = [float(np.abs(g).max()) for g in grads]
    out[2] = float((np.abs(grads[1]) * dt).sum())
    return out


def _torch_ssd_grads(ssd, arrs, D, st0, wy, ws):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs + [st0]]
    y, st = ssd(*leaves[:5], torch.from_numpy(D), leaves[5])
    ((y * torch.from_numpy(wy)).sum()
     + (st * torch.from_numpy(ws)).sum()).backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("B,S,nh,hp,ns,cl", FULL_SHAPES)
def test_ssd_op_gradient_matches_jax(monkeypatch, B, S, nh, hp, ns, cl,
                                     dt_scale=1.0):
    """The gradient of ops.ssd (through SSDChunk) in x, dt, A_log, B, C
    and the initial state against jax.grad of the JAX ssd_chunked, on
    random weights of y and of the final state."""
    rng = np.random.default_rng(9)
    f = np.float32
    arrs = _inputs(B, S, nh, hp, ns, seed=8, dt_scale=dt_scale)
    D = rng.standard_normal(nh).astype(f)
    st0 = (rng.standard_normal((B, nh, hp, ns)) * 0.2).astype(f)
    wy = rng.standard_normal((B, S, nh, hp)).astype(f)
    ws = rng.standard_normal((B, nh, hp, ns)).astype(f)
    calls = []
    apply = ssd_ops.SSDChunk.apply
    monkeypatch.setattr(ssd_ops.SSDChunk, "apply",
                        lambda *a: calls.append(a[-1]) or apply(*a))
    got = _torch_ssd_grads(
        lambda *a: ssd_ops.ssd(*a[:6], chunk=cl, state=a[6]), arrs, D, st0,
        wy, ws)
    assert calls == [cl]
    want = [np.asarray(b) for b in _jax_ssd_grads(arrs, D, st0, wy, ws,
                                                  cl)]
    scales = _scales(want, arrs[1])
    for name, a, b, scale in zip(("x", "dt", "A_log", "B", "C", "state"),
                                 got, want, scales):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=JAX_TOL * scale, err_msg=f"d{name}")


def test_ssd_op_gradient_slow_decay_matches_jax(monkeypatch):
    """The same with slow decay, three chunks of 128 and a padded S: the
    state carried from chunk to chunk weighs as much as the chunk's own
    terms."""
    test_ssd_op_gradient_matches_jax(monkeypatch, 1, 300, 2, 8, 4, 128,
                                     dt_scale=SLOW_DT)


@settings(max_examples=25, deadline=None)
@given(cl=st.integers(1, 40), hp=st.sampled_from([4, 8, 12]),
       ns=st.sampled_from([4, 8, 12]), nc=st.integers(1, 3),
       rem=st.integers(0, 39), seed=st.integers(0, 2 ** 16))
def test_ssd_op_gradient_over_shapes(cl, hp, ns, nc, rem, seed):
    """Over drawn chunk lengths, head shapes and S mod cl (a padded last
    chunk when it is not 0), the gradient of ops.ssd equals autograd of
    the port's plain ssd_chunked to FP32_TOL of each largest element
    (``_scales``)."""
    rem %= cl
    S = (nc - 1) * cl + rem if rem else nc * cl
    B, nh = 1, 2
    rng = np.random.default_rng(seed)
    arrs = _inputs(B, S, nh, hp, ns, seed=seed)
    D = rng.standard_normal(nh).astype(np.float32)
    st0 = (rng.standard_normal((B, nh, hp, ns)) * 0.2).astype(np.float32)
    wy = rng.standard_normal((B, S, nh, hp)).astype(np.float32)
    ws = rng.standard_normal((B, nh, hp, ns)).astype(np.float32)
    got = _torch_ssd_grads(
        lambda *a: ssd_ops.ssd(*a[:6], chunk=cl, state=a[6]), arrs, D, st0,
        wy, ws)
    want = _torch_ssd_grads(
        lambda *a: tmamba.ssd_chunked(*a[:6], cl, state=a[6],
                                      return_state=True), arrs, D, st0, wy,
        ws)
    scales = _scales([b.numpy() for b in want], arrs[1])
    for name, a, b, scale in zip(("x", "dt", "A_log", "B", "C", "state"),
                                 got, want, scales):
        torch.testing.assert_close(
            a, b, rtol=0, atol=FP32_TOL * scale,
            msg=f"d{name} at S={S} cl={cl} hp={hp} ns={ns}")


def test_backward_kernel_wrapper_takes_cuda_tensors_only():
    """On CPU tensors the wrapper raises (ops.ssd sends those to the plain
    backward); it never falls back itself."""
    arrs = [torch.from_numpy(a) for a in _inputs(1, 32, 2, 8, 4)]
    cots = [torch.from_numpy(c) for c in _cotangents(1, 32, 2, 8, 4, 16)]
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_chunk_bwd(*arrs, *cots, chunk=16)
