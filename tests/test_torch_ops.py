"""The kernel ops as torch custom ops, on the CPU: each passes
``torch.library.opcheck``; on fake tensors of any device (a dry run's
trace) each gives its kernel's output shapes, launches nothing and runs
no plain version; ``FlopCounterMode`` counts each by its formula in
``roofline.work``; those formulas give ``PERF.md``'s bound column; and
the paged op's lse."""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attn import kernel as paged_kernel
from repro_torch.kernels.paged_attn import ops as paged_ops
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.roofline import work

OPS = ("flash_fwd", "flash_fwd_lse", "flash_bwd", "paged_attention",
       "paged_attention_lse", "ssd_chunk", "ssd_chunk_bwd")
FLASH = (True, 0, 0.125, 64, 0, "triangular")


def _args(dev="cpu", dtype=torch.float32, seed=0):
    """One small call of each kernel op: name -> positional arguments."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, dt=dtype):
        return torch.randn(shape, generator=g).to(dev, dt)
    q, k, v = r(1, 128, 4, 64), r(1, 128, 2, 64), r(1, 128, 2, 64)
    o, lse = flash_ops._fwd_lse(q.cpu(), k.cpu(), v.cpu(), *FLASH)
    o, lse = o.to(dev), lse.to(dev)
    table = torch.randperm(8, generator=g)[:6].reshape(2, 3).to(
        dev, torch.int32)
    lens = torch.tensor([40, 0], dtype=torch.int32, device=dev)
    paged = (r(2, 4, 64), r(8, 16, 2, 64), r(8, 16, 2, 64), table, lens,
             0.125)
    x, Bm, Cm = r(1, 64, 2, 16), r(1, 64, 8), r(1, 64, 8)
    dt = torch.nn.functional.softplus(r(1, 64, 2, dt=torch.float32))
    A_log = r(2, dt=torch.float32)
    cots = [r(*s, dt=torch.float32) for s in
            ((1, 2, 32, 2, 16), (1, 2, 2, 16, 8), (1, 2, 32, 2), (1, 2, 2))]
    return {"flash_fwd": (q, k, v, *FLASH), "flash_fwd_lse": (q, k, v, *FLASH),
            "flash_bwd": (q, k, v, o, lse, o, *FLASH),
            "paged_attention": paged, "paged_attention_lse": paged,
            "ssd_chunk": (x, dt, A_log, Bm, Cm, 32),
            "ssd_chunk_bwd": (x, dt, A_log, Bm, Cm, *cots, 32)}


@pytest.mark.parametrize("name", OPS)
def test_kernel_op_passes_opcheck_on_cpu(name):
    """Schema, fake version against the plain version's outputs (shapes,
    dtypes, strides) and dispatch under AOT tracing."""
    torch.library.opcheck(getattr(torch.ops.repro_torch, name),
                          _args()[name])


def _launches():
    return (flash_kernel.flash_attention_fwd.launches,
            flash_kernel.flash_attention_bwd.launches,
            paged_kernel.paged_attention.launches,
            ssd_kernel.ssd_chunk_call.launches,
            ssd_kernel.ssd_chunk_bwd.launches)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name", OPS)
def test_fake_call_takes_the_kernel_route(name, device, monkeypatch):
    """On fake tensors (of the CPU, or of a card this machine need not
    have) each op gives the shapes and dtypes of its real outputs and
    calls neither the kernel's wrapper nor the plain version; FlopCounterMode
    counts it by its formula."""
    real = _args()[name]
    want = getattr(torch.ops.repro_torch, name)(*real)
    want = want if isinstance(want, tuple) else (want,)
    for mod, fn in ((flash_ops, "flash_attention_fwd_ref"),
                    (flash_ops, "flash_attention_bwd_ref"),
                    (paged_ops, "paged_attention_ref"),
                    (ssd_ops, "ssd_chunk_ref"), (ssd_ops, "ssd_chunk_bwd_ref"),
                    (flash_ops, "flash_attention_fwd"),
                    (paged_ops, "_kernel"), (ssd_ops, "ssd_chunk_call")):
        monkeypatch.setattr(mod, fn, None)   # a call would raise
    before = _launches()
    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        fake = [mode.from_tensor(a, static_shapes=True)
                if isinstance(a, torch.Tensor) else a for a in real]
        if device == "cuda":
            fake = [torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                        device="cuda")
                    if isinstance(a, torch.Tensor) else a for a in fake]
        with FlopCounterMode(display=False) as fc:
            got = getattr(torch.ops.repro_torch, name)(*fake)
    got = got if isinstance(got, tuple) else (got,)
    assert _launches() == before
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == device for t in got)
    assert fc.get_total_flops() == work.op_work(name, real)[1] > 0


def test_work_formulas_give_the_bound_column():
    """``PERF.md`` §6's bound column (bf16, ms), from the formulas: flash
    (4, 512, 32, 64), its backward (2, 4096, 32, 64), paged at hd 64 (34
    pages, 543 positions), the SSD at zamba2's prefill and its backward at
    zamba2's training call."""
    bf = work.PEAK_FLOPS["bfloat16"]
    got = {
        "flash": work.bound_ms(*work.flash_fwd_work(
            4, 512, 512, 32, 32, 64, 64, 2), bf),
        "flash bwd": work.bound_ms(*work.flash_bwd_work(
            2, 4096, 4096, 32, 32, 64, 64, 2), bf),
        "paged": work.bound_ms(*work.paged_work(4, 32, 32, 64, 543, 34, 2),
                               bf),
        "ssd": work.bound_ms(*work.ssd_work(4, 512, 80, 64, 64, 256, 2),
                             work.TF32_FLOPS),
        "ssd bwd": work.bound_ms(*work.ssd_bwd_work(1, 4096, 80, 64, 64, 256,
                                                    2), work.TF32_FLOPS)}
    want = {"flash": (0.0100, "bytes"), "flash bwd": (0.3475, "operations"),
            "paged": (0.0053, "bytes"), "ssd": (0.0225, "bytes"),
            "ssd bwd": (0.0581, "bytes")}
    assert {k: (round(ms, 4), by) for k, (ms, by) in got.items()} == want


def test_work_copies_the_ssd_backward_pieces():
    """``roofline.work`` keeps its own copy of the bf16 SSD backward's
    operand pieces (it imports no kernel module): the same as the
    kernel's ``ref.BWD_PIECES``."""
    from repro_torch.kernels.ssd_scan.ref import BWD_PIECES
    assert work.BWD_PIECES == BWD_PIECES


@pytest.mark.parametrize("S,Sk,causal,window", [
    (7, 7, True, 0), (5, 9, True, 0), (9, 5, True, 0), (8, 8, True, 3),
    (6, 4, False, 0), (10, 10, False, 4)])
def test_attended_pairs_counts_the_mask(S, Sk, causal, window):
    from repro_torch.kernels.flash_attention.ref import allowed
    mask = allowed(torch.arange(S), torch.arange(Sk), causal, window)
    assert work.attended_pairs(S, Sk, causal, window) == int(mask.sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_lse_and_zero_length_row(dtype):
    """The plain version's lse is each row's logsumexp of its scaled
    scores over its positions; a zero-length row keeps the mean of V over
    the table's slots and gets lse <= -1e30."""
    q, kp, vp, table, lens, scale = _args(dtype=dtype)["paged_attention"]
    out, lse = paged_ops.paged_attention(q, kp, vp, table, lens,
                                         scale=scale, with_lse=True)
    assert torch.equal(out, paged_ops.paged_attention(q, kp, vp, table,
                                                      lens, scale=scale))
    kf = kp[table[0].long()].reshape(-1, 2, 64)[:40].float()
    qf = q[0].float().reshape(2, 2, 64)
    s = torch.einsum("kgd,skd->kgs", qf, kf).reshape(4, 40) * scale
    torch.testing.assert_close(lse[0], torch.logsumexp(s, -1), atol=1e-5,
                               rtol=1e-5)
    assert bool((lse[1] <= -1e30).all())
    vmean = vp[table[1].long()].reshape(-1, 2, 64).float().mean(0)
    torch.testing.assert_close(out[1].float(),
                               vmean.repeat_interleave(2, 0).to(dtype).float(),
                               atol=2e-2 if dtype == torch.bfloat16 else 1e-5,
                               rtol=1e-2)
