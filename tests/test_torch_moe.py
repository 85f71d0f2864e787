"""The moe family on the CPU against the JAX package: ``moe_ffn`` (the
dispatch groups of serving and of training, with and without capacity
drops, y, aux and the gradient of every leaf), and the smoke
mixtral-8x22b and deepseek-v2-lite-16b models end to end (forward, the
prefill cache, decode continuing it, greedy generation and one train
step), with JAX weights carried over through numpy
(``repro_torch.interop``). Also mixtral's sliding-window ring cache.

Model-level parity is held in fp32. In bf16 the two packages round
activations at other places, and a router whose top two probabilities
are a rounding apart sends a token to another expert: that token's output
then moves by O(1) (measured at smoke size with no capacity drops: up to
2.8 on logits up to 5, at 1 to 32 of 128 positions), and with drops a
flip reorders every later slot of its expert. So bf16 is held module by
module on the same inputs (``moe_ffn`` here, MLA in
``test_torch_mla.py``), and the port's own bf16 prefill/decode agreement
as the JAX package's test holds its own."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.steps import ce_loss as jax_ce_loss
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serve import ServeLoop as JaxServeLoop
from repro_torch import interop
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.launch.steps import loss_and_grads, make_prefill_step, \
    make_train_step
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.optim import adamw_init
from repro_torch.serve import ServeLoop
from repro_torch.tree import tree_leaves

ARCHS = ("mixtral-8x22b", "deepseek-v2-lite-16b")
# fp32: summation order only; bf16: one rounding of y (tests/test_kernels.py
# :110), the same tolerances as test_torch_lm.py
TOLS = {"float32": 1e-4, "bfloat16": 5e-2}
# the gradient of each leaf, elementwise within this share of the leaf's
# largest element (fp32, summation order)
GRAD_TOL = 1e-4
# prefill/decode consistency: tests/test_models.py:135
CONSISTENCY = (1e-1, 3e-2)


def _cfgs(arch, compute_dtype="float32", capacity_factor=None, **kw):
    out = []
    for get in (jax_smoke, torch_smoke):
        cfg = get(arch).replace(compute_dtype=compute_dtype, **kw)
        if capacity_factor is not None:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor))
        out.append(cfg)
    return out


def _weights(jcfg, tcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = interop.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(t, j, tol, msg=""):
    np.testing.assert_allclose(_np(t), _np(j), atol=tol, rtol=tol,
                               err_msg=msg)


def _layer0(tree):
    return {k: (_layer0(v) if isinstance(v, dict) else v[0])
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_moe_defs_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    j, t = jmoe.moe_defs(jcfg, (3,)), tmoe.moe_defs(tcfg, (3,))
    assert {k: (d.shape, d.logical, d.init, d.scale) for k, d in t.items()} \
        == {k: (d.shape, d.logical, d.init, d.scale) for k, d in j.items()}
    assert tmoe.expert_split(tcfg) == jmoe.expert_split(jcfg) == \
        {"mixtral-8x22b": 4, "deepseek-v2-lite-16b": 2}[arch]
    for S in (1, 4, 64, 256, 1024, 4096):
        assert tmoe.capacity(tcfg, S) == jmoe.capacity(jcfg, S)


def _moe_inputs(arch, S, capacity_factor, seed=1):
    """One layer's weights, and x ~ N(0, 1) shifted by 3 along the first
    expert's router column: unshifted, the tokens spread so evenly over the
    experts that a group of 64 overflows none at capacity 1.25."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=capacity_factor)
    jp, tp = _weights(jcfg, tcfg)
    pj, pt = _layer0(jp["layers"])["moe"], _layer0(tp["layers"])["moe"]
    r0 = np.asarray(pj["router"])[:, 0]
    x = np.random.default_rng(seed).standard_normal(
        (2, S, jcfg.d_model)) + 3 * r0 / np.linalg.norm(r0)
    return jcfg, tcfg, pj, pt, x.astype(np.float32)


def _kept_share(cfg, p, x):
    """The share of (token, k) slots kept under the capacity, computed
    from the JAX router (the test's own count, not the port's)."""
    m = cfg.moe
    B, S, D = x.shape
    G = jmoe.MODEL_AXIS if S % 16 == 0 and S >= 1024 else 1
    C = jmoe.capacity(cfg, S // G)
    probs = jax.nn.softmax(np.asarray(x, np.float32).reshape(
        B, G, S // G, D) @ np.asarray(p["router"]), axis=-1)
    _, ids = jax.lax.top_k(probs, m.top_k)
    ids = np.asarray(ids).reshape(B, G, -1)
    kept = 0
    for b in range(B):
        for g in range(G):
            counts = np.bincount(ids[b, g], minlength=m.n_experts)
            kept += np.minimum(counts, C).sum()
    return kept / ids.size


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0],
                         ids=["drops", "drop_free"])
@pytest.mark.parametrize("S", [64, 1024], ids=["G1", "G16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, S, capacity_factor, compute_dtype):
    """y and aux on the same input: S = 64 routes in one group (serving),
    S = 1024 in 16 (the training route); capacity 1.25 drops slots, 8.0
    none."""
    jcfg, tcfg, pj, pt, x = _moe_inputs(arch, S, capacity_factor)
    kept = _kept_share(jcfg, pj, x)
    assert (kept < 1.0) if capacity_factor == 1.25 else (kept == 1.0)
    jdt, tdt = getattr(jnp, compute_dtype), getattr(torch, compute_dtype)
    yj, aj = jmoe.moe_ffn(jcfg, pj, jnp.asarray(x).astype(jdt), jdt)
    yt, at = tmoe.moe_ffn(tcfg, pt, torch.from_numpy(x).to(tdt), tdt)
    assert yt.dtype == tdt and tuple(yt.shape) == x.shape
    assert at.dtype == torch.float32 and at.shape == ()
    _close(yt, yj, TOLS[compute_dtype], "y")
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)


@pytest.mark.parametrize("S", [64, 1024], ids=["G1", "G16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_gradients_match_jax(arch, S):
    """The gradient of Σ y·w + aux in every leaf and in x, against
    ``jax.grad`` of the JAX ``moe_ffn`` (fp32, capacity 1.25: with
    drops)."""
    jcfg, tcfg, pj, pt, x = _moe_inputs(arch, S, 1.25)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_ffn(jcfg, p, xx, jnp.float32)
        return (y * w).sum() + aux
    gj, gxj = jax.grad(jloss, argnums=(0, 1))(pj, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in pt.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_ffn(tcfg, leaves, xt, torch.float32)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    for name, t in [("x", xt)] + sorted(leaves.items()):
        ref = np.asarray(gxj if name == "x" else gj[name])
        got = t.grad.numpy()
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= GRAD_TOL, f"{name}: {err:.3e}"
    assert np.abs(np.asarray(gj["router"])).max() > 0


def test_moe_capacity_drops_are_bounded():
    """Twin of test_models.py::test_moe_capacity_drops_are_bounded."""
    tcfg = torch_smoke("mixtral-8x22b")
    params = tlm.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    p_moe = _layer0(params["layers"])["moe"]
    x = torch.randn((2, 64, tcfg.d_model),
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    y, aux = tmoe.moe_ffn(tcfg, p_moe, x, torch.bfloat16)
    assert y.shape == x.shape
    assert float(aux) >= 0
    assert not bool(torch.isnan(y.float()).any())


def test_top_k_breaks_ties_as_jax():
    """Equal router probabilities go to the lower expert index first, as
    ``jax.lax.top_k`` orders them (torch.topk does not promise it)."""
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.1],
                      [0.25, 0.25, 0.25, 0.25, 0.0],
                      [0.0, 0.2, 0.2, 0.2, 0.4]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tmoe._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# the smoke models end to end
# ---------------------------------------------------------------------------

def _jgrow(cache, full):
    out = {}
    for n in full:
        if cache[n].shape == full[n].shape:
            out[n] = cache[n]
        else:
            sl = tuple(slice(0, s) for s in cache[n].shape)
            out[n] = full[n].at[sl].set(cache[n])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_cache_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _weights(jcfg, tcfg)
    toks = _tokens(jcfg, (2, 64))
    jl, jaux, _ = jlm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, taux, none = tlm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 64, tlm.padded_vocab(tcfg.vocab_size))
    assert none is None and taux.shape == ()
    _close(tl, jl, TOLS["float32"], "logits")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)

    jlast, jcache = jax_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    tlast, tcache = make_prefill_step(tcfg)(tp,
                                            {"tokens": torch.from_numpy(toks)})
    _close(tlast, jlast, TOLS["float32"], "last logits")
    defs = tlm.cache_spec_defs(tcfg, 64, 2)
    assert set(tcache) == set(jcache) == set(defs)
    for n in tcache:
        assert tcache[n].dtype == torch.bfloat16
        assert tuple(tcache[n].shape) == jcache[n].shape == defs[n].shape
        _close(tcache[n], jcache[n], TOLS["bfloat16"], n)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax_on_carried_cache(arch):
    """Two decode steps continuing a carried-over JAX prefill cache (the
    second reads the first's write): logits and the cache."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _weights(jcfg, tcfg, seed=1)
    S0, max_len = 20, 32
    toks = _tokens(jcfg, (2, S0), seed=1)
    _, jcache = jax_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    full = _jgrow(jcache, jlm.init_cache(jcfg, max_len, 2))
    tcache = interop.cache_from_numpy(
        tcfg, {n: np.asarray(a) for n, a in full.items()}, device="cpu")
    nxt = _tokens(jcfg, (2, 1), seed=2)
    for step in range(2):
        jlog, full = jlm.decode_step(jcfg, jp, full, jnp.asarray(nxt),
                                     jnp.int32(S0 + step))
        tlog, tnew = tlm.decode_step(tcfg, tp, tcache, torch.from_numpy(nxt),
                                     S0 + step)
        assert tnew is tcache                   # updated in place
        _close(tlog, jlog, TOLS["float32"], f"logits, step {step}")
        for n in tnew:
            _close(tnew[n], full[n], TOLS["bfloat16"], f"{n}, step {step}")
        nxt = np.array(jnp.argmax(jlog[:, :jcfg.vocab_size], -1),
                       np.int32)[:, None]


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_equal_jax_serve_loop(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _weights(jcfg, tcfg, seed=2)
    prompt = _tokens(jcfg, (2, 16), seed=3)
    jgen = JaxServeLoop(jcfg, jp, max_len=32).generate(jnp.asarray(prompt), 8)
    tgen = ServeLoop(tcfg, tp, max_len=32, device="cpu").generate(prompt, 8)
    assert tgen.dtype == torch.int32 and tuple(tgen.shape) == (2, 8)
    np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))


def test_generate_at_any_cache_length_equals_jax_serve_loop():
    """mixtral's sliding-window cache at 40 positions (two and a half
    pages, under the smoke window of 64): 32 new tokens from a prompt of
    12 run past position 40, so decode writes the ring at pos % 40, the
    logical length, as JAX does, and reads it through whole pages."""
    jcfg, tcfg = _cfgs("mixtral-8x22b")
    jp, tp = _weights(jcfg, tcfg, seed=2)
    prompt = _tokens(jcfg, (2, 12), seed=3)
    jgen = JaxServeLoop(jcfg, jp, max_len=40).generate(jnp.asarray(prompt),
                                                        32)
    tgen = ServeLoop(tcfg, tp, max_len=40, device="cpu").generate(prompt, 32)
    assert tuple(tgen.shape) == (2, 32)
    np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_and_gradients_match_jax(arch):
    """One step's loss (cross-entropy + the MoE aux) and every gradient
    leaf, against ``jax.value_and_grad`` of the JAX loss (fp32; the
    training route of 16 dispatch groups at S = 1024)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _weights(jcfg, tcfg, seed=3)
    t = _tokens(jcfg, (1, 1024), seed=4)
    b = {"tokens": t, "labels": np.roll(t, -1, axis=1)}
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def jloss(p):
        logits, aux, _ = jlm.forward(jcfg, p, jb)
        return jax_ce_loss(jcfg, logits, jb["labels"]) + aux
    lj, gj = jax.jit(jax.value_and_grad(jloss))(jp)
    lt, gt = loss_and_grads(tcfg, tp, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    tl, jl = tree_leaves(gt), jax.tree_util.tree_leaves(gj)
    assert len(tl) == len(jl)
    for i, (a, r) in enumerate(zip(tl, jl)):
        a, r = a.double().numpy(), np.asarray(r, np.float64)
        err = np.abs(a - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= 5e-5, f"leaf {i}: {err:.3e}"


def _batch(cfg, B=2, S=64, seed=0):
    t = _tokens(cfg, (B, S), seed)
    return {"tokens": torch.from_numpy(t),
            "labels": torch.from_numpy(np.roll(t, -1, axis=1))}


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_decode(arch):
    """Twin of test_models.py::test_smoke_forward_and_decode."""
    cfg = torch_smoke(arch)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    logits, aux, _ = tlm.forward(cfg, params, _batch(cfg))
    assert logits.shape == (2, 64, tlm.padded_vocab(cfg.vocab_size))
    assert not bool(torch.isnan(logits.float()).any()) and float(aux) >= 0
    cache = tlm.init_cache(cfg, 64, 2, device="cpu")
    lg, cache = tlm.decode_step(cfg, params, cache,
                                torch.zeros((2, 1), dtype=torch.int32), 0)
    assert not bool(torch.isnan(lg.float()).any())


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step(arch):
    """Twin of test_models.py::test_smoke_train_step."""
    cfg = torch_smoke(arch)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    before = [t.clone() for t in tree_leaves(params)]
    step = make_train_step(cfg, peak_lr=1e-2, warmup=1)
    p2, _, m = step(params, adamw_init(params), _batch(cfg, seed=1))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert sum(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(p2))) == len(before)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch, compute_dtype):
    """Twin of test_models.py::test_prefill_decode_consistency: decode
    steps continuing a prefill of 32 tokens give the logits of one full
    forward over 36, at capacity 8.0 (no slot drops: drops depend on the
    dispatch group by design, so forward and decode agree only without
    them). JAX's weights for its seed 7; tokens from numpy."""
    jcfg, tcfg = _cfgs(arch, compute_dtype, capacity_factor=8.0)
    _, params = _weights(jcfg, tcfg, seed=7)
    S0, S1 = 32, 36
    toks = torch.from_numpy(_tokens(tcfg, (2, S1), seed=7))
    full_logits, _, _ = tlm.forward(tcfg, params, {"tokens": toks})
    atol, rtol = CONSISTENCY
    lg, cache = make_prefill_step(tcfg)(params, {"tokens": toks[:, :S0]})
    np.testing.assert_allclose(_np(lg), _np(full_logits[:, S0 - 1]),
                               atol=atol, rtol=rtol)
    cache = tlm.grow_cache(tcfg, cache, 48)
    for pos in range(S0, S1):
        lg, cache = tlm.decode_step(tcfg, params, cache,
                                    toks[:, pos:pos + 1], pos)
        np.testing.assert_allclose(_np(lg), _np(full_logits[:, pos]),
                                   atol=atol, rtol=rtol, err_msg=str(pos))


def test_cast_params_keeps_the_router_and_latent_norm_fp32():
    """The leaves read in fp32 (the router, MLA's ``ckv_norm``) stay fp32
    under ``cast_params``, and the cast tree gives bit-identical logits."""
    for arch in ARCHS:
        _, tcfg = _cfgs(arch, "bfloat16")
        params = tlm.init_params(tcfg, torch.Generator().manual_seed(8),
                                 device="cpu")
        cast = tlm.cast_params(tcfg, params, torch.bfloat16)
        assert cast["layers"]["moe"]["router"].dtype == torch.float32
        assert cast["layers"]["moe"]["w1"].dtype == torch.bfloat16
        if tcfg.mla is not None:
            assert cast["layers"]["attn"]["ckv_norm"].dtype == torch.float32
            assert cast["dense_layers"]["mlp"]["w1"].dtype == torch.bfloat16
        toks = torch.from_numpy(_tokens(tcfg, (2, 16), seed=8))
        a, _, _ = tlm.forward(tcfg, params, {"tokens": toks})
        b, _, _ = tlm.forward(tcfg, cast, {"tokens": toks})
        assert torch.equal(a, b), arch


# ---------------------------------------------------------------------------
# mixtral's sliding window: the ring cache
# ---------------------------------------------------------------------------

def test_swa_prefill_that_breaks_ring_order_raises():
    """A prompt longer than the window and not a multiple of it (96 at the
    smoke window of 64) cannot be laid out in the ring order decode writes
    (position p at slot p % 64): the port raises. This departs from the
    JAX package on purpose: its ``prefill_cache`` keeps such a prompt's
    last 64 positions in prompt order, and its decode then reads keys at
    the wrong slots and silently computes wrong logits."""
    _, tcfg = _cfgs("mixtral-8x22b")
    params = tlm.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    toks = torch.from_numpy(_tokens(tcfg, (2, 96)))
    with pytest.raises(ValueError, match="ring"):
        make_prefill_step(tcfg)(params, {"tokens": toks})
    caches = tlm.forward(tcfg, params, {"tokens": toks},
                         collect_cache=True)[2]
    with pytest.raises(ValueError, match="ring"):
        tlm.prefill_cache(tcfg, caches, 96)


@pytest.mark.parametrize("S0", [128, 48], ids=["multiple", "within"])
def test_swa_decode_past_the_window_matches_jax_and_the_forward(S0):
    """Prompts of 128 (a multiple of the 64-slot window) and 48 (within
    it), then 24 decode steps, past the window in both (capacity 8.0: no
    slot drops, fp32). The port's ring cache after prefill is JAX's; from
    JAX's cache carried over, every step's logits equal JAX's decode; from
    the port's own prefill, they equal a full forward over the whole
    sequence."""
    jcfg, tcfg = _cfgs("mixtral-8x22b", capacity_factor=8.0)
    jp, tp = _weights(jcfg, tcfg, seed=5)
    S1 = S0 + 24
    toks = _tokens(jcfg, (2, S1), seed=5)
    full_logits, _, _ = tlm.forward(tcfg, tp, {"tokens": torch.from_numpy(
        toks)})
    _, jcache = jax_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(
        toks[:, :S0])})
    _, own = make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(
        toks[:, :S0])})
    for n in ("k", "v"):
        assert tuple(own[n].shape) == jcache[n].shape
        assert own[n].shape[2] == min(S0, tcfg.swa_window)
        _close(own[n], jcache[n], TOLS["bfloat16"], n)
    own = tlm.grow_cache(tcfg, own, S1)
    jfull = _jgrow(jcache, jlm.init_cache(jcfg, S1, 2))
    carried = interop.cache_from_numpy(
        tcfg, {n: np.asarray(a) for n, a in jfull.items()}, device="cpu")
    assert own["k"].shape[2] == carried["k"].shape[2] == tcfg.swa_window
    jstep = jax.jit(lambda c, t, p: jlm.decode_step(jcfg, jp, c, t, p))
    for pos in range(S0, S1):
        tok = toks[:, pos:pos + 1]
        jlog, jfull = jstep(jfull, jnp.asarray(tok), jnp.int32(pos))
        tlog, carried = tlm.decode_step(tcfg, tp, carried,
                                        torch.from_numpy(tok), pos)
        _close(tlog, jlog, TOLS["float32"], f"vs JAX at {pos}")
        olog, own = tlm.decode_step(tcfg, tp, own, torch.from_numpy(tok),
                                    pos)
        np.testing.assert_allclose(_np(olog), _np(full_logits[:, pos]),
                                   atol=CONSISTENCY[0], rtol=CONSISTENCY[1],
                                   err_msg=f"vs forward at {pos}")
