"""The kernel ops as torch custom ops, on the CPU: each passes
``torch.library.opcheck``; on fake tensors of any device (a dry run's
trace) each gives its kernel's output shapes, launches nothing and runs
no plain version; ``FlopCounterMode`` counts each by its formula in
``roofline.work`` (the MoE slot op, integers only, has none); those
formulas give ``PERF.md``'s bound column; the paged op's lse; the MoE
slot op's plain version against the JAX package's formula; and the AdamW
ops: opcheck, a fake update that writes nothing and declares the
parameters and both moments mutated, fake norm partials of the card's
shape, and their bytes."""

import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels.adamw import kernel as adamw_kernel
from repro_torch.kernels.adamw import ops as adamw_ops
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.moe_slots import kernel as slots_kernel
from repro_torch.kernels.moe_slots import ops as slots_ops
from repro_torch.kernels.paged_attn import kernel as paged_kernel
from repro_torch.kernels.paged_attn import ops as paged_ops
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.roofline import work

OPS = ("flash_fwd", "flash_fwd_lse", "flash_bwd", "paged_attention",
       "paged_attention_lse", "ssd_chunk", "ssd_chunk_bwd", "moe_slots")
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
    # 3 groups of 40 slots over 16 experts, 4 slots an expert: drops
    eid = torch.randint(0, 16, (3, 40), generator=g).to(dev)
    return {"flash_fwd": (q, k, v, *FLASH), "flash_fwd_lse": (q, k, v, *FLASH),
            "flash_bwd": (q, k, v, o, lse, o, *FLASH),
            "paged_attention": paged, "paged_attention_lse": paged,
            "ssd_chunk": (x, dt, A_log, Bm, Cm, 32),
            "ssd_chunk_bwd": (x, dt, A_log, Bm, Cm, *cots, 32),
            "moe_slots": (eid, 16, 4)}


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
            ssd_kernel.ssd_chunk_bwd.launches,
            slots_kernel.moe_slots.launches)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name", OPS)
def test_fake_call_takes_the_kernel_route(name, device, monkeypatch):
    """On fake tensors (of the CPU, or of a card this machine need not
    have) each op gives the shapes and dtypes of its real outputs and
    calls neither the kernel's wrapper nor the plain version; FlopCounterMode
    counts it by its formula (the MoE slot op, integers only, by none: 0)."""
    real = _args()[name]
    want = getattr(torch.ops.repro_torch, name)(*real)
    want = want if isinstance(want, tuple) else (want,)
    for mod, fn in ((flash_ops, "flash_attention_fwd_ref"),
                    (flash_ops, "flash_attention_bwd_ref"),
                    (paged_ops, "paged_attention_ref"),
                    (ssd_ops, "ssd_chunk_ref"), (ssd_ops, "ssd_chunk_bwd_ref"),
                    (slots_ops, "moe_slots_ref"),
                    (flash_ops, "flash_attention_fwd"),
                    (paged_ops, "_kernel"), (ssd_ops, "ssd_chunk_call"),
                    (slots_ops, "_kernel")):
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
    flops = work.op_work(name, real)[1]
    assert fc.get_total_flops() == flops
    assert (flops > 0) == (name != "moe_slots")


def test_work_formulas_give_the_bound_column():
    """``PERF.md`` §6's bound column (bf16, ms), from the formulas: flash
    (4, 512, 32, 64), its backward (2, 4096, 32, 64), paged at hd 64 (34
    pages, 543 positions), the SSD at zamba2's prefill and its backward at
    zamba2's training call, and the MoE slot op at a 16k prompt's one
    group of 98,304 slots over 64 experts."""
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
                                                    2), work.TF32_FLOPS),
        "moe slots": work.bound_ms(*work.moe_slots_work(1, 98304, 64), bf)}
    want = {"flash": (0.0100, "bytes"), "flash bwd": (0.3475, "operations"),
            "paged": (0.0053, "bytes"), "ssd": (0.0225, "bytes"),
            "ssd bwd": (0.0581, "bytes"), "moe slots": (0.0007, "bytes")}
    assert {k: (round(ms, 4), by) for k, (ms, by) in got.items()} == want


def _adamw_args(dev="cpu", dtype=torch.float32):
    """One small call of each AdamW op: leaves of 2, 1 and 3 dims (sizes
    no multiple of 4), moments not zero, and the four scalars."""
    g = torch.Generator().manual_seed(0)
    shapes = ((5, 3), (7,), (2, 3, 5))
    p, gr = ([torch.randn(s, generator=g).to(dev, dtype) for s in shapes]
             for _ in range(2))
    m = [torch.randn(s, generator=g).to(dev) for s in shapes]
    v = [torch.rand(s, generator=g).to(dev) for s in shapes]
    sc, lr, bc1, bc2 = (torch.tensor(x, device=dev)
                        for x in (0.5, 0.01, 0.19, 0.0975))
    return {"adamw_sumsq": (gr,),
            "adamw_norm": (torch.rand(4, generator=g).to(dev), 1.0),
            "adamw_update_": (p, gr, m, v, sc, lr, bc1, bc2, 0.9, 0.95,
                              1e-8, 0.1)}


@pytest.mark.parametrize("name", ["adamw_sumsq", "adamw_norm",
                                  "adamw_update_"])
def test_adamw_ops_pass_opcheck_on_cpu(name):
    """Schema (the update's declared mutations against what its plain
    version writes), fake version and dispatch under AOT tracing."""
    torch.library.opcheck(getattr(torch.ops.repro_torch, name),
                          _adamw_args()[name])


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_adamw_fake_update_writes_nothing_and_declares_its_writes(
        device, monkeypatch):
    """The update's schema marks params, m and v written and nothing else;
    on fake tensors (of the CPU, or of a card this machine need not have)
    the update returns nothing, the sum of squares its partials (each
    leaf's fp32 sum on the CPU, the card's ``NORM_BLOCKS`` fp64) and the
    norm two 0-d fp32 tensors, with no launch and no plain version run."""
    from repro_torch.kernels.adamw import ops as ops_mod
    schema = torch.ops.repro_torch.adamw_update_.default._schema
    written = {a.name for a in schema.arguments
               if a.alias_info is not None and a.alias_info.is_write}
    assert written == {"params", "m", "v"} and not schema.returns
    blocks = adamw_kernel.NORM_BLOCKS
    for fn in ("adamw_sumsq_ref", "adamw_norm_ref", "adamw_update_ref"):
        monkeypatch.setattr(ops_mod, fn, None)     # a call would raise
    monkeypatch.setattr(ops_mod, "_kernel", type("K", (), {
        "NORM_BLOCKS": blocks}))
    before = (adamw_kernel.adamw_sumsq.launches,
              adamw_kernel.adamw_norm.launches,
              adamw_kernel.adamw_update_.launches)
    args = _adamw_args()
    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        def fake(a):
            if isinstance(a, list):
                return [fake(t) for t in a]
            if not isinstance(a, torch.Tensor):
                return a
            if device == "cuda":
                return torch.empty_strided(a.shape, a.stride(),
                                           dtype=a.dtype, device="cuda")
            return mode.from_tensor(a, static_shapes=True)
        upd = [fake(a) for a in args["adamw_update_"]]
        assert torch.ops.repro_torch.adamw_update_(*upd) is None
        partial = torch.ops.repro_torch.adamw_sumsq(
            *[fake(a) for a in args["adamw_sumsq"]])
        n, scale = torch.ops.repro_torch.adamw_norm(partial, 1.0)
    assert (adamw_kernel.adamw_sumsq.launches,
            adamw_kernel.adamw_norm.launches,
            adamw_kernel.adamw_update_.launches) == before
    assert (partial.shape, partial.dtype) == (
        ((3,), torch.float32) if device == "cpu"
        else ((blocks,), torch.float64))
    assert [(t.shape, t.dtype, t.device.type) for t in (n, scale)] == \
        [(torch.Size([]), torch.float32, device)] * 2


@pytest.mark.parametrize("dtype,per_elem", [(torch.float32, (4, 28)),
                                            (torch.bfloat16, (2, 22))])
def test_adamw_work_charges_bytes(dtype, per_elem):
    """The norm reads each gradient element once; the update reads p, g,
    m and v and writes p, m and v (m and v fp32): 4 and 28 B an fp32
    element, 2 and 22 B with bf16 p and g; the finish its partials and
    two fp32 outputs; no operations."""
    args = _adamw_args(dtype=dtype)
    n = sum(t.numel() for t in args["adamw_sumsq"][0])
    assert work.op_work("adamw_sumsq", args["adamw_sumsq"]) == \
        (per_elem[0] * n, 0)
    assert work.op_work("adamw_norm", args["adamw_norm"]) == (4 * 4 + 8, 0)
    assert work.adamw_norm_work(adamw_kernel.NORM_BLOCKS) == \
        (8 * adamw_kernel.NORM_BLOCKS + 8, 0)
    assert work.op_work("adamw_update_", args["adamw_update_"]) == \
        (per_elem[1] * n, 0)
    assert work.bound_ms(*work.adamw_update_work(2_839_831_040), 1)[1] == \
        "bytes"


def test_adamw_ops_take_a_list_and_refuse_an_empty_one():
    """The public functions take any iterable of leaves; an empty one has
    no device to run on and raises."""
    args = _adamw_args()
    n, _ = adamw_ops.adamw_norm(
        adamw_ops.adamw_sumsq(iter(args["adamw_sumsq"][0])), 1.0)
    assert torch.equal(n, torch.sqrt(sum(torch.sum(torch.square(g))
                                         for g in args["adamw_sumsq"][0])))
    with pytest.raises(ValueError, match="at least one"):
        adamw_ops.adamw_sumsq([])
    one = torch.ones(())
    with pytest.raises(ValueError, match="at least one"):
        adamw_ops.adamw_update_([], [], [], [], one, one, one, one, b1=0.9,
                                b2=0.95, eps=1e-8, weight_decay=0.1)


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


def _jax_slot_lines():
    """The lines of the JAX package's ``moe_ffn`` that give each slot's
    position, keep flag and slot (``repro/models/moe.py``, from the
    "group-local position" comment up to the scatter), as its source
    has them."""
    import inspect
    import textwrap

    from repro.models import moe as jax_moe
    src = inspect.getsource(jax_moe.moe_ffn)
    start = src.rindex("\n", 0, src.index("# group-local position")) + 1
    end = src.rindex("\n", 0, src.index("x_flat =")) + 1
    lines = textwrap.dedent(src[start:end])
    assert "jnp.cumsum(onehot, axis=2)" in lines and "slot =" in lines
    return lines


@pytest.mark.parametrize("BG,N,Ee,C", [(3, 600, 16, 8), (2, 4100, 64, 8),
                                       (1, 300, 64, 400)])
def test_moe_slots_ref_is_the_jax_formula(BG, N, Ee, C):
    """The slot op's plain version gives the JAX package's pos, keep and
    slot bit for bit: the lines of ``repro/models/moe.py``'s ``moe_ffn``
    that compute them, read from its source and run here on the same
    expert ids (BG groups of N slots as B 1, G BG, Sg N, Ke 1), so a
    change there reaches this test. Drop-heavy (C 8, one expert taking a
    third of the slots) and drop-free (C > N); its dest and kept follow
    from them."""
    import jax
    import jax.numpy as jnp
    g = torch.Generator().manual_seed(N)
    eid = torch.randint(0, Ee, (BG, N), generator=g)
    eid[:, ::3] = 5                                  # a skewed expert
    slot, keep, dest, kept = slots_ops.moe_slots(eid, Ee, C)

    env = {"jax": jax, "jnp": jnp, "B": 1, "G": BG, "Sg": N, "Ke": 1,
           "Ee": Ee, "C": C,
           "ids_e": jnp.asarray(eid.numpy()).reshape(1, BG, N, 1)}
    exec(_jax_slot_lines(), env)
    jkeep = np.asarray(env["keep"]).reshape(BG, N)
    jslot = np.asarray(env["slot"]).reshape(BG, N)
    assert np.array_equal(keep.numpy(), jkeep)
    assert np.array_equal(slot.numpy(), jslot)
    assert (C == 8) == (not bool(keep.all()))
    rows = Ee * C + 1
    want_dest = np.where(jkeep, jslot, Ee * C) \
        + np.arange(BG)[:, None] * rows
    assert np.array_equal(dest.numpy(), want_dest)
    counts = np.stack([np.bincount(r, minlength=Ee) for r in eid.numpy()])
    assert kept.dtype == torch.int32
    assert np.array_equal(kept.numpy(), np.minimum(counts, C))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-lite-16b"])
def test_dispatch_frac_equals_the_one_hot_mean(arch):
    """The load-balance share ``frac`` that ``moe._dispatch`` builds from
    the slot op's kept counts equals the mean over the slots of each kept
    slot's one-hot on its true expert, the formula it replaced, bit for
    bit on the CPU (mixtral: 2 sub-experts an expert; capacity drops in
    both)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    cfg = get_smoke_config(arch)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    m, split = cfg.moe, moe.expert_split(cfg)
    g = torch.Generator().manual_seed(1)
    xg = torch.randn((2, 1, 96, cfg.d_model), generator=g) \
        + torch.randn((cfg.d_model,), generator=g)      # alike: skewed
    router = torch.randn((cfg.d_model, m.n_experts), generator=g)
    x_e, slot, keep, gates_e, frac, imp = moe._dispatch(
        cfg, router, xg, torch.float32)
    assert not bool(keep.all())
    B, G, N = keep.shape
    eid = (slot // moe.capacity(cfg, 96)) // split        # true expert
    onehot = torch.nn.functional.one_hot(eid, m.n_experts)
    want = (onehot * keep[..., None]).float().mean(2)
    assert frac.dtype == torch.float32
    assert torch.equal(frac, want)
