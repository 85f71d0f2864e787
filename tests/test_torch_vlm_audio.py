"""The vlm (qwen2-vl-2b) and audio (musicgen-large) families of the port
against the JAX package on the CPU, with JAX weights carried over through
numpy (``repro_torch.interop``): parameter shapes, forward logits and the
prefill cache, decode on a carried cache, greedy generation, train steps
(also microbatched on patch embeddings with 3-stream M-RoPE positions),
and twins of ``tests/test_models.py``'s per-arch smoke tests.

vlm runs both on token ids and on ``embeds`` with a ``pos3`` whose three
streams differ (a 1 x 4 x 4 patch grid, then text positions), since equal
streams make M-RoPE plain RoPE and would hide a wrong section split.

The musicgen smoke config has head_dim 24, which the flash kernel does not
take (``kernels/flash_attention/kernel.py``: ``HEAD_DIMS``): it runs on
the CPU only, through the plain versions, as here; the full-width model
(head_dim 64) runs on the card in ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.steps import ce_loss as jax_ce_loss
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import adamw_init as jax_adamw_init
from repro.serve import ServeLoop as JaxServeLoop
from repro_torch import interop
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.launch.steps import (ce_loss, loss_and_grads,
                                      make_prefill_step, make_train_step)
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw_init
from repro_torch.serve import ServeLoop
from repro_torch.tree import tree_leaves, tree_map
# the tolerances and comparisons of the dense family's tests: TOLS (port
# vs JAX), CONSISTENCY_TOLS (prefill/decode vs forward), STEP_TOLS and
# ONE_STEP_PARAMS (train steps)
from test_torch_lm import CONSISTENCY_TOLS, TOLS, _close, _np
from test_torch_train import (ONE_STEP_PARAMS, STEP_TOLS,
                              _assert_rel_l2 as _rel_l2,
                              _assert_scaled_close as _scaled_close)

ARCHS = ("qwen2-vl-2b", "musicgen-large")
DTYPES = ("float32", "bfloat16")


def _cfgs(arch, compute_dtype="float32", **kw):
    return (jax_smoke(arch).replace(compute_dtype=compute_dtype, **kw),
            torch_smoke(arch).replace(compute_dtype=compute_dtype, **kw))


def _weights(jcfg, tcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = interop.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


def _tokens(cfg, B, S, seed=0):
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def patch_grid_pos3(B, S, grid=(1, 4, 4)):
    """(3, B, S) int32 M-RoPE ids: a t x h x w patch grid (stream t the
    frame, h the row, w the column), then text positions that go on from
    the grid's largest id + 1 on all three streams (Qwen2-VL's layout)."""
    t, h, w = np.meshgrid(*(np.arange(n) for n in grid), indexing="ij")
    img = np.stack([t.ravel(), h.ravel(), w.ravel()])       # (3, n_patch)
    n_txt = S - img.shape[1]
    txt = np.arange(n_txt) + img.max() + 1
    one = np.concatenate([img, np.stack([txt] * 3)], axis=1)
    return np.broadcast_to(one[:, None], (3, B, S)).astype(np.int32).copy()


def _embeds(cfg, B, S, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _vocab_shape(cfg, *lead):
    V = tlm.padded_vocab(cfg.vocab_size)
    return tuple(lead) + ((cfg.n_codebooks, V) if cfg.n_codebooks else (V,))


# ---------------------------------------------------------------------------
# layers: M-RoPE, the 3-dim rope branch, sinusoidal positions
# ---------------------------------------------------------------------------

def test_mrope_and_sinusoids_match_jax():
    """M-RoPE on three distinct streams (each section rotated by its own
    stream), the (B, S, hd/2) branch of apply_rope, and the sinusoidal
    table (numpy, equal to the JAX package's bit for bit)."""
    pos3 = patch_grid_pos3(2, 24)
    assert not np.array_equal(pos3[0], pos3[1])         # streams differ
    for hd, sec in ((32, (4, 6, 6)), (128, (16, 24, 24))):
        jc, js = jlayers.mrope_cos_sin(jnp.asarray(pos3), hd, 1e6, sec)
        tc, ts = tlayers.mrope_cos_sin(torch.from_numpy(pos3), hd, 1e6, sec)
        assert tuple(tc.shape) == jc.shape == (2, 24, hd // 2)
        _close(tc, jc, 1e-6, "cos")
        _close(ts, js, 1e-6, "sin")
        x = np.random.default_rng(hd).standard_normal(
            (2, 24, 3, hd)).astype(np.float32)
        _close(tlayers.apply_rope(torch.from_numpy(x), tc, ts),
               jlayers.apply_rope(jnp.asarray(x), jc, js), 1e-5, "rope")
    np.testing.assert_array_equal(tlayers.sinusoidal_positions(40, 96),
                                  jlayers.sinusoidal_positions(40, 96))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_shapes_equal_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    for cfgs in ((jcfg, tcfg), (jax_smoke(arch).replace(
            n_layers=3), torch_smoke(arch).replace(n_layers=3))):
        jd = jax.tree_util.tree_map(
            lambda d: tuple(d.shape), jlm.param_defs(cfgs[0]),
            is_leaf=lambda x: isinstance(x, jlayers.ParamDef))
        td = tlm.param_defs(cfgs[1])

        def shapes(t):
            return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                    for k, v in t.items()}
        assert shapes(td) == jd
    if tcfg.n_codebooks:
        K, V = tcfg.n_codebooks, tlm.padded_vocab(tcfg.vocab_size)
        assert td["embed"].shape == (K, V, tcfg.d_model)
        assert td["head"].shape == (tcfg.d_model, K * V)


def test_codebook_embedding_sums_in_jax_order():
    """The K codebook embeddings are added left to right in the compute
    dtype, as the JAX package adds them: bit for bit in bf16 (a sum in
    fp32 rounded once gives other bits)."""
    jcfg, tcfg = _cfgs("musicgen-large", "bfloat16")
    jp, tp = _weights(jcfg, tcfg, seed=5)
    toks = _tokens(jcfg, 3, 40, seed=5)
    je = jlm.embed_tokens(jcfg, jp, jnp.asarray(toks), jnp.bfloat16)
    te = tlm.embed_tokens(tcfg, tp, torch.from_numpy(toks), torch.bfloat16)
    assert te.dtype == torch.bfloat16 and tuple(te.shape) == je.shape
    np.testing.assert_array_equal(te.view(torch.uint16).numpy(),
                                  np.asarray(je).view(np.uint16))
    once = sum(tp["embed"][k][torch.from_numpy(toks[..., k]).long()]
               for k in range(4)).to(torch.bfloat16)
    assert not torch.equal(once, te)           # the order is observable


# ---------------------------------------------------------------------------
# serving: forward, prefill cache, decode, generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_cache_match_jax(arch, compute_dtype):
    jcfg, tcfg = _cfgs(arch, compute_dtype)
    jp, tp = _weights(jcfg, tcfg)
    toks = _tokens(jcfg, 2, 32)
    jl, _, _ = jlm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, aux, none = tlm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert tuple(tl.shape) == _vocab_shape(tcfg, 2, 32)
    assert tl.dtype == tcfg.compute_dt() and none is None and aux == 0.0
    tol = TOLS[compute_dtype]
    _close(tl, jl, tol, "logits")
    jlast, jcache = jax_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    tlast, tcache = make_prefill_step(tcfg)(tp,
                                            {"tokens": torch.from_numpy(toks)})
    _close(tlast, jlast, tol, "last logits")
    assert set(tcache) == set(jcache) == {"k", "v"}
    for n in ("k", "v"):
        assert tcache[n].dtype == torch.bfloat16
        assert tuple(tcache[n].shape) == jcache[n].shape
        _close(tcache[n], jcache[n], TOLS["bfloat16"], n)


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_vlm_embeds_and_patch_grid_pos3_match_jax(compute_dtype):
    """Prefill from patch embeddings with distinct M-RoPE streams; the
    same input with three equal streams gives other logits (the sections
    matter), and no pos3 means three equal streams 0..S-1."""
    jcfg, tcfg = _cfgs("qwen2-vl-2b", compute_dtype)
    jp, tp = _weights(jcfg, tcfg, seed=1)
    emb, pos3 = _embeds(jcfg, 2, 32, seed=1), patch_grid_pos3(2, 32)
    jb = {"embeds": jnp.asarray(emb), "pos3": jnp.asarray(pos3)}
    tb = {"embeds": torch.from_numpy(emb), "pos3": torch.from_numpy(pos3)}
    tol = TOLS[compute_dtype]
    jl, _, _ = jlm.forward(jcfg, jp, jb)
    tl, _, _ = tlm.forward(tcfg, tp, tb)
    _close(tl, jl, tol, "logits")
    jlast, jcache = jax_prefill_step(jcfg)(jp, jb)
    tlast, tcache = make_prefill_step(tcfg)(tp, tb)
    _close(tlast, jlast, tol, "last logits")
    for n in ("k", "v"):
        assert tuple(tcache[n].shape) == jcache[n].shape
        _close(tcache[n], jcache[n], TOLS["bfloat16"], n)
    plain, _, _ = tlm.forward(tcfg, tp, {"embeds": tb["embeds"]})
    eq = np.stack([np.arange(32)] * 3)[:, None].repeat(2, 1)
    same, _, _ = tlm.forward(tcfg, tp, {"embeds": tb["embeds"],
                                        "pos3": torch.from_numpy(eq)})
    assert torch.equal(plain, same)
    assert (plain - tl).abs().max() > 10 * tol


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax_on_carried_cache(arch, compute_dtype):
    """Two decode steps on a cache carried over from JAX's prefill (vlm:
    from patch embeddings with a patch-grid pos3; a decode step at
    position p rotates all three M-RoPE streams by p, as the JAX package
    does; audio: the fp32 sinusoidal row at p)."""
    jcfg, tcfg = _cfgs(arch, compute_dtype)
    jp, tp = _weights(jcfg, tcfg, seed=2)
    S0, max_len = 20, 32
    if tcfg.family == "vlm":
        jb = {"embeds": jnp.asarray(_embeds(jcfg, 2, S0, seed=2)),
              "pos3": jnp.asarray(patch_grid_pos3(2, S0))}
    else:
        jb = {"tokens": jnp.asarray(_tokens(jcfg, 2, S0, seed=2))}
    _, jcache = jax_prefill_step(jcfg)(jp, jb)
    full = jlm.init_cache(jcfg, max_len, 2)
    full = {n: full[n].at[:, :, :S0].set(jcache[n]) for n in full}
    tcache = interop.cache_from_numpy(
        tcfg, {n: np.asarray(a) for n, a in full.items()}, device="cpu")
    nxt = _tokens(jcfg, 2, 1, seed=3)
    tol = TOLS[compute_dtype]
    for step in range(2):
        jlog, full = jlm.decode_step(jcfg, jp, full, jnp.asarray(nxt),
                                     jnp.int32(S0 + step))
        tlog, tnew = tlm.decode_step(tcfg, tp, tcache,
                                     torch.from_numpy(nxt), S0 + step)
        assert tnew is tcache
        assert tuple(tlog.shape) == _vocab_shape(tcfg, 2)
        _close(tlog, jlog, tol, f"logits, step {step}")
        for n in ("k", "v"):
            _close(tnew[n], full[n], TOLS["bfloat16"], f"{n}, step {step}")
        nxt = np.array(jnp.argmax(jlog[..., :jcfg.vocab_size], -1),
                       np.int32)[:, None]


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_equal_jax_serve_loop(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _weights(jcfg, tcfg, seed=2)
    prompt = _tokens(jcfg, 2, 16, seed=3)
    jgen = JaxServeLoop(jcfg, jp, max_len=32).generate(jnp.asarray(prompt), 8)
    tgen = ServeLoop(tcfg, tp, max_len=32, device="cpu").generate(prompt, 8)
    want = (2, 8, tcfg.n_codebooks) if tcfg.n_codebooks else (2, 8)
    assert tgen.dtype == torch.int32 and tuple(tgen.shape) == want
    np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_decode(arch):
    """Twin of test_models.py::test_smoke_forward_and_decode."""
    cfg = torch_smoke(arch)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    B, S = 2, 64
    if cfg.family == "vlm":
        p1 = torch.arange(S)[None].repeat(B, 1)
        batch = {"embeds": torch.randn((B, S, cfg.d_model),
                                       generator=torch.Generator()
                                       .manual_seed(0)).to(torch.bfloat16),
                 "pos3": torch.stack([p1, p1, p1])}
    else:
        batch = {"tokens": torch.from_numpy(_tokens(cfg, B, S))}
    logits, aux, _ = tlm.forward(cfg, params, batch)
    assert tuple(logits.shape) == _vocab_shape(cfg, B, S)
    assert not torch.isnan(logits.float()).any()
    cache = tlm.init_cache(cfg, S, B, device="cpu")
    tok = torch.zeros((B, 1, cfg.n_codebooks) if cfg.n_codebooks else (B, 1),
                      dtype=torch.int32)
    lg, cache = tlm.decode_step(cfg, params, cache, tok, 0)
    assert not torch.isnan(lg.float()).any()


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch, compute_dtype):
    """Twin of test_models.py::test_prefill_decode_consistency: prefill on
    32 tokens, then decode steps give the logits of one full forward over
    36 tokens (audio: the decode step's fp32 sinusoidal row against the
    forward's float64 table)."""
    jcfg, tcfg = _cfgs(arch, compute_dtype)
    _, params = _weights(jcfg, tcfg, seed=7)
    S0, S1 = 32, 36
    toks = torch.from_numpy(_tokens(tcfg, 2, S1, seed=7))
    full_logits, _, _ = tlm.forward(tcfg, params, {"tokens": toks})
    atol, rtol = CONSISTENCY_TOLS[compute_dtype]
    lg, cache = make_prefill_step(tcfg)(params, {"tokens": toks[:, :S0]})
    np.testing.assert_allclose(_np(lg), _np(full_logits[:, S0 - 1]),
                               atol=atol, rtol=rtol)
    cache = tlm.grow_cache(tcfg, cache, 48)
    for pos in range(S0, S1):
        lg, cache = tlm.decode_step(tcfg, params, cache,
                                    toks[:, pos:pos + 1], pos)
        np.testing.assert_allclose(_np(lg), _np(full_logits[:, pos]),
                                   atol=atol, rtol=rtol, err_msg=str(pos))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _train_batch(cfg, i, B=2, S=32):
    rng = np.random.default_rng(100 + i)
    labels = _tokens(cfg, B, S, seed=200 + i)
    if cfg.family == "vlm":
        return {"embeds": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32), "pos3": patch_grid_pos3(B, S),
                "labels": labels}
    t = _tokens(cfg, B, S, seed=100 + i)
    return {"tokens": t, "labels": np.roll(t, -1, axis=1)}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_loss_and_grads(cfg, params, b):
    jb = _jb(b)
    return jax.value_and_grad(lambda p: jax_ce_loss(
        cfg, jlm.forward(cfg, p, jb)[0], jb["labels"]))(params)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step(arch):
    """Twin of test_models.py::test_smoke_train_step."""
    cfg = torch_smoke(arch)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    before = tree_map(lambda t: t.clone(), params)
    step = make_train_step(cfg, peak_lr=1e-2, warmup=1)
    p2, o2, m = step(params, adamw_init(params), _tb(_train_batch(cfg, 0)))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert not torch.allclose(tree_leaves(before)[1], tree_leaves(p2)[1])
    assert int(o2.step) == 1


def _carry(tcfg, tree):
    return interop.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch, compute_dtype):
    """Three steps of the port against three JAX steps from the same
    weights and batches (vlm on patch embeddings with a patch-grid pos3;
    audio on (B, S, K) tokens and labels), at tests/test_torch_train.py's
    STEP_TOLS: loss, grad norm and lr of the two runs every step; and
    every step, from the JAX run's state before it carried over (its
    parameters and AdamW moments), the gradients elementwise (bf16: the
    first step), then the parameters and the first moment after the
    port's step against the JAX step's. From its own state the port's run
    parts further than the step does: AdamW's first steps move a
    parameter whose gradient is near 0 by up to 2·lr in one package only,
    which here reaches 2.3e-4 of a leaf's largest gradient from step 1 on
    (the same parameters give <= 1e-6 in fp32) and 1.02e-5 relative L2
    on one parameter leaf after three steps."""
    from repro_torch.optim.adamw import AdamWState
    jcfg, tcfg = _cfgs(arch, compute_dtype)
    jp, tp = _weights(jcfg, tcfg)
    jo, to = jax_adamw_init(jp), adamw_init(tp)
    jstep = jax.jit(jax_train_step(jcfg, peak_lr=1e-2, warmup=2))
    tstep = make_train_step(tcfg, peak_lr=1e-2, warmup=2)
    tol = STEP_TOLS[compute_dtype]
    for i in range(3):
        b = _train_batch(jcfg, i)
        sp = _carry(tcfg, jp)
        so = AdamWState(step=torch.tensor(int(jo.step), dtype=torch.int32),
                        m=_carry(tcfg, jo.m), v=_carry(tcfg, jo.v))
        if compute_dtype == "float32" or i == 0:
            _, jg = _jax_loss_and_grads(jcfg, jp, b)
            _, tg = loss_and_grads(tcfg, sp, _tb(b))
            _scaled_close(tg, jg, tol["grads"], f"grads step {i}")
        jp, jo, jm = jstep(jp, jo, _jb(b))
        tp, to, tm = tstep(tp, to, _tb(b))
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=tol[name],
                                       err_msg=f"{name} step {i}")
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        sp, so, _ = tstep(sp, so, _tb(b))
        _rel_l2(sp, jp, tol["params"], f"params after step {i}")
        _rel_l2(so.m, jo.m, 2 * tol["grads"], f"m after step {i}")
    assert int(to.step) == int(jo.step) == 3


def test_vlm_microbatched_step_on_embeds_and_pos3_matches_jax():
    """Microbatches on patch embeddings with a pos3 whose streams differ
    from row to row: pos3 is split on its batch axis (axis 1), as in the
    JAX package, so each microbatch keeps its own rows' streams. Three
    microbatches: the JAX step first splits every input on axis 0
    (``repro/launch/steps.py:68-69``), pos3's 3 streams included, before
    it splits pos3 again on axis 1, so it runs only when the count
    divides 3 (with 2 it raises a reshape TypeError; ROADMAP Queue 3)."""
    jcfg, tcfg = _cfgs("qwen2-vl-2b", microbatches=3)
    jp, tp = _weights(jcfg, tcfg, seed=3)
    b = _train_batch(jcfg, 0, B=6)
    b["pos3"] = np.concatenate([patch_grid_pos3(2, 32),
                                patch_grid_pos3(2, 32, grid=(1, 2, 8)),
                                patch_grid_pos3(2, 32, grid=(2, 2, 2))],
                               axis=1)
    jp, _, jm = jax.jit(jax_train_step(jcfg, peak_lr=1e-2, warmup=1))(
        jp, jax_adamw_init(jp), _jb(b))
    tp, _, tm = make_train_step(tcfg, peak_lr=1e-2, warmup=1)(
        tp, adamw_init(tp), _tb(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    _rel_l2(tp, jp, ONE_STEP_PARAMS, "params")


def test_pos3_microbatches_two_equal_one():
    """The microbatched gradient of a batch with per-row pos3 equals the
    whole batch's: a split on axis 0 of pos3 would mix up the streams."""
    _, tcfg = _cfgs("qwen2-vl-2b")
    _, tp = _weights(*_cfgs("qwen2-vl-2b"), seed=4)
    b = _train_batch(tcfg, 1, B=4)
    b["pos3"] = np.concatenate([patch_grid_pos3(2, 32),
                                patch_grid_pos3(2, 32, grid=(2, 2, 2))],
                               axis=1)
    l1, g1 = loss_and_grads(tcfg, tp, _tb(b))
    l2, g2 = loss_and_grads(tcfg.replace(microbatches=2), tp, _tb(b))
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    assert not g1["embed"].any() and not g2["embed"].any()  # not read
    for a, c in zip(tree_leaves(g1), tree_leaves(g2)):
        err = (c - a).abs().max() / a.abs().max().clamp_min(1e-30)
        assert float(err) <= 1e-5


def test_audio_ce_loss_matches_jax():
    """(B, S, K, V) logits and (B, S, K) labels: the mean over every
    codebook's position."""
    jcfg, tcfg = _cfgs("musicgen-large")
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((2, 8, 4, 128)).astype(np.float32)
    labels = rng.integers(0, 128, (2, 8, 4)).astype(np.int32)
    np.testing.assert_allclose(
        float(ce_loss(tcfg, torch.from_numpy(logits),
                      torch.from_numpy(labels))),
        float(jax_ce_loss(jcfg, jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)
