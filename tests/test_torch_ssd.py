"""The port's SSD on the CPU against the JAX package, on the same numpy
inputs: the SSD chunk kernel's plain version (``ssd_chunk_ref``, the
kernel's contract) against the Pallas kernel in interpret mode piece by
piece, and the full SSD (``ops.ssd`` and ``models.mamba.ssd_chunked``)
against ``repro``'s Pallas SSD and its oracle. The split arithmetic of the
kernel's bf16 tensor-core instance (``ssd_chunk_split_ref``) is held
against both at the serving head shapes, and fewer split pieces are shown
to lose the margin. The CUDA kernel itself is held against
``ssd_chunk_ref`` and ``ssd_chunk_split_ref`` on a card by
tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_chunk_call as pk_chunk
from repro.kernels.ssd_scan.ops import ssd as pk_ssd
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_ref,
                                              ssd_chunk_split_ref, ssd_ref)
from repro_torch.models import mamba as tmamba

ATOL, RTOL = 2e-5, 2e-4                 # tests/test_kernels.py: SSD sweep
SSD_SHAPES = [                          # tests/test_kernels.py:38-42
    (2, 128, 4, 32, 16, 32),
    (1, 256, 8, 16, 32, 64),
    (2, 64, 2, 64, 64, 64),
]
PIECES = ("y_diag", "states", "exp_cs", "exp_tot")
# one or two chunks of 256 tokens with zamba2-2.7b's (hp 64, ns 64) and
# mamba2-130m's (hp 64, ns 128) head shapes, a few heads
SERVING_HEAD_SHAPES = [
    (1, 512, 2, 64, 64, 256),
    (2, 256, 3, 64, 64, 256),
    (1, 256, 4, 64, 128, 256),
    (1, 512, 2, 64, 128, 256),
]


def _inputs(B, S, nh, hp, ns, seed=0, state=False):
    """The distributions of tests/test_kernels.py's SSD sweep, from numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (rng.standard_normal((B, S, nh, hp)) * 0.5).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(f)
    A_log = (rng.standard_normal(nh) * 0.3).astype(f)
    B_ = (rng.standard_normal((B, S, ns)) * 0.5).astype(f)
    C_ = (rng.standard_normal((B, S, ns)) * 0.5).astype(f)
    D_ = np.ones(nh, f)
    out = [x, dt, A_log, B_, C_, D_]
    if state:
        out.append((rng.standard_normal((B, nh, hp, ns)) * 0.2).astype(f))
    return out


def _jax(arrs):
    return [jnp.asarray(a) for a in arrs]


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _close(t, j, msg="", atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=rtol, err_msg=msg)


@pytest.mark.parametrize("B,S,nh,hp,ns,cl", SSD_SHAPES)
def test_chunk_pieces_match_pallas(B, S, nh, hp, ns, cl):
    x, dt, A_log, B_, C_, _ = _inputs(B, S, nh, hp, ns)
    want = pk_chunk(*_jax([x, dt, A_log, B_, C_]), chunk=cl, interpret=True)
    got = ssd_chunk_ref(*_torch([x, dt, A_log, B_, C_]), chunk=cl)
    for name, t, j in zip(PIECES, got, want):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape, name
        _close(t, j, name)


def test_chunk_pieces_read_bf16_inputs_as_pallas_does():
    """bf16 x/B/C (the serving path's dtype) are read as they are and
    converted to fp32, as ``astype(jnp.float32)`` does in the Pallas body."""
    x, dt, A_log, B_, C_, _ = _inputs(2, 128, 4, 32, 16, seed=1)
    jx, jB, jC = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, B_, C_))
    want = pk_chunk(jx, jnp.asarray(dt), jnp.asarray(A_log), jB, jC,
                    chunk=64, interpret=True)
    tx, tB, tC = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, B_, C_))
    got = ssd_chunk_ref(tx, torch.from_numpy(dt), torch.from_numpy(A_log),
                        tB, tC, chunk=64)
    for name, t, j in zip(PIECES, got, want):
        _close(t, j, name)


def _bf16_case(B, S, nh, hp, ns, seed):
    """bf16 x/B/C (the serving dtype) for the split arithmetic: the torch
    tensors and the same values as JAX arrays."""
    x, dt, A_log, B_, C_, _ = _inputs(B, S, nh, hp, ns, seed=seed)
    tx, tB, tC = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, B_, C_))
    jx, jB, jC = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, B_, C_))
    t = (tx, torch.from_numpy(dt), torch.from_numpy(A_log), tB, tC)
    j = (jx, jnp.asarray(dt), jnp.asarray(A_log), jB, jC)
    return t, j


@pytest.mark.parametrize("B,S,nh,hp,ns,cl", SERVING_HEAD_SHAPES + SSD_SHAPES)
def test_split_arithmetic_matches_plain_and_pallas(B, S, nh, hp, ns, cl):
    """The bf16 tensor-core instance's decomposition (C·Bᵀ in one bf16
    pass, the scores and the state weights each split into three bf16
    pieces) against ssd_chunk_ref and the Pallas kernel in interpret mode,
    at the kernel's tolerance."""
    t, j = _bf16_case(B, S, nh, hp, ns, seed=8)
    got = ssd_chunk_split_ref(*t, chunk=cl)
    ref = ssd_chunk_ref(*t, chunk=cl)
    want = pk_chunk(*j, chunk=cl, interpret=True)
    for name, g, r, w in zip(PIECES, got, ref, want):
        assert g.dtype == torch.float32 and g.shape == r.shape, name
        _close(g, r.numpy(), f"{name} vs ssd_chunk_ref")
        _close(g, w, f"{name} vs pallas")


@pytest.mark.parametrize("pieces", [1, 2])
def test_fewer_split_pieces_lose_the_margin(pieces):
    """Why the scores are split in three: at cl 256 a single unsplit bf16
    pass misses the tolerance by far (y and the states); two pieces use
    more than a tenth of it on y, over twenty times what three use."""
    t, _ = _bf16_case(1, 512, 2, 64, 64, seed=9)
    ref = ssd_chunk_ref(*t, chunk=256)

    def worst(out):           # max of err / (atol + rtol |ref|), y and st
        return [float(((o - r).abs() / (ATOL + RTOL * r.abs())).max())
                for o, r in zip(out[:2], ref[:2])]
    three = worst(ssd_chunk_split_ref(*t, chunk=256))
    fewer = worst(ssd_chunk_split_ref(*t, chunk=256, pieces=pieces))
    assert max(three) < 0.05, three
    if pieces == 1:
        assert min(fewer) > 10, fewer
    else:
        assert fewer[0] > 0.1 and fewer[0] > 20 * three[0], (fewer, three)


@pytest.mark.parametrize("B,S,nh,hp,ns,cl", SSD_SHAPES)
def test_full_ssd_matches_pallas_and_oracle(B, S, nh, hp, ns, cl):
    arrs = _inputs(B, S, nh, hp, ns, seed=2)
    jy, jst = pk_ssd(*_jax(arrs), chunk=cl, interpret=True)
    ry, rst = jax_ssd_ref(*_jax(arrs), cl)
    T = _torch(arrs)
    for name, (y, st) in {
            "ops.ssd": ssd_ops.ssd(*T, chunk=cl),
            "ssd_ref": ssd_ref(*T, cl),
            "ssd_chunked": tmamba.ssd_chunked(*T, cl, return_state=True),
    }.items():
        assert y.dtype == torch.float32 and tuple(y.shape) == (B, S, nh, hp)
        for what, want in (("pallas", (jy, jst)), ("oracle", (ry, rst))):
            _close(y, want[0], f"{name} y vs {what}")
            _close(st, want[1], f"{name} state vs {what}")


def test_full_ssd_with_initial_state():
    """tests/test_kernels.py::test_ssd_kernel_with_initial_state's shape."""
    x, dt, A_log, B_, C_, _, st0 = _inputs(1, 64, 2, 16, 8, seed=3,
                                           state=True)
    D_ = np.zeros(2, np.float32)
    arrs = [x, dt, A_log, B_, C_, D_]
    jy, jst = pk_ssd(*_jax(arrs), chunk=32, state=jnp.asarray(st0),
                     interpret=True)
    T = _torch(arrs)
    y, st = ssd_ops.ssd(*T, chunk=32, state=torch.from_numpy(st0))
    _close(y, jy, "y")
    _close(st, jst, "state")
    y2, st2 = tmamba.ssd_chunked(*T, 32, state=torch.from_numpy(st0),
                                 return_state=True)
    _close(y2, jy, "ssd_chunked y")
    _close(st2, jst, "ssd_chunked state")


@pytest.mark.parametrize("S,cl", [(100, 32), (7, 4)])
def test_full_ssd_pads_to_a_whole_chunk(S, cl):
    """S not a multiple of the chunk: padded with dt=0 tokens, sliced off."""
    arrs = _inputs(2, S, 3, 16, 8, seed=4)
    jy, jst = pk_ssd(*_jax(arrs), chunk=cl, interpret=True)
    y, st = ssd_ops.ssd(*_torch(arrs), chunk=cl)
    assert tuple(y.shape) == (2, S, 3, 16)
    _close(y, jy, "y")
    _close(st, jst, "state")


def test_chunk_of_one_token_is_the_decode_recurrence():
    """cl = 1 (each decode step of the model): the chunked SSD equals the
    single-token recurrence ``ssd_decode_step`` applied token by token."""
    x, dt, A_log, B_, C_, D_, st0 = _inputs(2, 6, 4, 16, 8, seed=5,
                                            state=True)
    T = _torch([x, dt, A_log, B_, C_, D_])
    jy, jst = pk_ssd(*_jax([x, dt, A_log, B_, C_, D_]), chunk=1,
                     state=jnp.asarray(st0), interpret=True)
    y, st = ssd_ops.ssd(*T, chunk=1, state=torch.from_numpy(st0))
    _close(y, jy, "y vs pallas")
    _close(st, jst, "state vs pallas")
    xs, dts, _, Bs, Cs, _ = T
    state = torch.from_numpy(st0)
    for s in range(6):
        ys, state = tmamba.ssd_decode_step(xs[:, s], dts[:, s], T[2],
                                           Bs[:, s], Cs[:, s], T[5], state)
        _close(y[:, s], ys.numpy(), f"token {s}")
    _close(st, state.numpy(), "final state")


@pytest.mark.parametrize("chunk", [16, 32, 64, 128])
def test_ssd_chunk_size_invariance(chunk):
    """Twin of tests/test_properties.py::test_ssd_chunk_size_invariance:
    the SSD output does not depend on the chunk length."""
    arrs = _torch(_inputs(1, 128, 2, 16, 8, seed=6))
    y_ref = tmamba.ssd_chunked(*arrs, 128)
    for name, y in (("ssd_chunked", tmamba.ssd_chunked(*arrs, chunk)),
                    ("ops.ssd", ssd_ops.ssd(*arrs, chunk=chunk)[0])):
        _close(y, y_ref.numpy(), name, atol=1e-4, rtol=1e-3)


def test_ssd_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises; ops.ssd picks the plain version from
    the tensor's device, and then nothing is launched."""
    x, dt, A_log, B_, C_, D_ = _torch(_inputs(1, 64, 2, 16, 8))
    before = ssd_kernel.ssd_chunk_call.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_chunk_call(x, dt, A_log, B_, C_, chunk=32)
    ssd_ops.ssd(x, dt, A_log, B_, C_, D_, chunk=32)
    assert ssd_kernel.ssd_chunk_call.launches == before
