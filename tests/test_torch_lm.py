"""The port's serving path against the JAX package on the CPU, with JAX
weights carried over through numpy (``repro_torch.interop``): forward
logits, the prefill cache, a decode step on a carried-over cache, and
greedy generation, for the dense family (stablelm-1.6b) and for the ssm
(mamba2-130m) and hybrid (zamba2-2.7b) families; the forward of every
registered architecture (``list_archs()``). The vlm/audio and moe
families have their own files (``test_torch_vlm_audio.py``,
``test_torch_moe.py``, ``test_torch_mla.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.steps import ce_loss as jax_ce_loss
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import lm as jlm
from repro.serve import ServeLoop as JaxServeLoop
from repro_torch import interop
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.configs import list_archs
from repro_torch.launch.steps import ce_loss, loss_and_grads, \
    make_prefill_step
from repro_torch.models import lm as tlm
from repro_torch.serve import ServeLoop
from repro_torch.tree import tree_map

ARCH = "stablelm-1.6b"
SSM_ARCHS = ("mamba2-130m", "zamba2-2.7b")
# fp32 compute: summation order only; bf16: tests/test_kernels.py:110
TOLS = {"float32": 1e-4, "bfloat16": 5e-2}


def _cfgs(compute_dtype, arch=ARCH):
    return (jax_smoke(arch).replace(compute_dtype=compute_dtype),
            torch_smoke(arch).replace(compute_dtype=compute_dtype))


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
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(t, j, tol, msg=""):
    np.testing.assert_allclose(_np(t), _np(j), atol=tol, rtol=tol,
                               err_msg=msg)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_cache_match_jax(compute_dtype):
    jcfg, tcfg = _cfgs(compute_dtype)
    jp, tp = _weights(jcfg, tcfg)
    toks = _tokens(jcfg, (2, 32))
    jl, _, _ = jlm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, aux, none = tlm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 32, tlm.padded_vocab(tcfg.vocab_size))
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


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax_on_carried_cache(compute_dtype):
    jcfg, tcfg = _cfgs(compute_dtype)
    jp, tp = _weights(jcfg, tcfg, seed=1)
    S0, max_len = 20, 32
    toks = _tokens(jcfg, (2, S0), seed=1)
    _, jcache = jax_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    full = jlm.init_cache(jcfg, max_len, 2)
    full = {n: full[n].at[:, :, :S0].set(jcache[n]) for n in full}
    tcache = interop.cache_from_numpy(
        tcfg, {n: np.asarray(a) for n, a in full.items()}, device="cpu")
    nxt = _tokens(jcfg, (2, 1), seed=2)

    jlog, jnew = jlm.decode_step(jcfg, jp, full, jnp.asarray(nxt),
                                 jnp.int32(S0))
    tlog, tnew = tlm.decode_step(tcfg, tp, tcache, torch.from_numpy(nxt), S0)
    assert tnew is tcache                       # updated in place
    tol = TOLS[compute_dtype]
    _close(tlog, jlog, tol, "logits")
    for n in ("k", "v"):
        _close(tnew[n], jnew[n], TOLS["bfloat16"], n)
        # untouched positions stay bit-equal to the carried-over cache
        np.testing.assert_array_equal(
            tnew[n][:, :, :S0].view(torch.uint16).numpy(),
            np.asarray(full[n][:, :, :S0]).view(np.uint16))


def test_generate_tokens_equal_jax_serve_loop():
    jcfg, tcfg = _cfgs("float32")
    jp, tp = _weights(jcfg, tcfg, seed=2)
    prompt = _tokens(jcfg, (2, 16), seed=3)
    jgen = JaxServeLoop(jcfg, jp, max_len=32).generate(jnp.asarray(prompt), 8)
    tgen = ServeLoop(tcfg, tp, max_len=32, device="cpu").generate(prompt, 8)
    assert tgen.dtype == torch.int32 and tuple(tgen.shape) == (2, 8)
    np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))


def test_serve_greedy_matches_forward():
    """Twin of test_substrate.py::test_serve_greedy_matches_forward:
    greedy decode equals argmax of a full forward at each position.

    The smoke vocab's bf16 logits often tie exactly (many seeds give two
    equal maxima, where argmax is decided by rounding); with this seed the
    forward's top two logits differ by at least 0.078 at every step."""
    jcfg, tcfg = _cfgs("bfloat16")
    _, params = _weights(jcfg, tcfg, seed=2)
    prompt = torch.from_numpy(_tokens(tcfg, (2, 16), seed=2))
    gen = ServeLoop(tcfg, params, max_len=48, device="cpu").generate(prompt, 6)
    seq = torch.cat([prompt, gen], dim=1)
    logits, _, _ = tlm.forward(tcfg, params, {"tokens": seq})
    for j in range(6):
        expect = logits[:, 16 + j - 1, :tcfg.vocab_size].argmax(-1)
        np.testing.assert_array_equal(gen[:, j].numpy(), expect.numpy())


def test_lm_module_holds_the_tree_and_ce_loss_matches():
    jcfg, tcfg = _cfgs("float32")
    jp, tp = _weights(jcfg, tcfg, seed=6)
    model = tlm.LM(tcfg, tp)
    tree = model.param_tree()
    assert torch.equal(tree["layers"]["attn"]["wq"], tp["layers"]["attn"]["wq"])
    assert sum(p.numel() for p in model.parameters()) == \
        sum(a.size for a in jax.tree_util.tree_leaves(jp))
    toks = _tokens(tcfg, (2, 16), seed=6)
    logits, _, _ = model(torch.from_numpy(toks))
    jlog, _, _ = jlm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    _close(logits, jlog, TOLS["float32"])
    labels = _tokens(tcfg, (2, 16), seed=7)
    np.testing.assert_allclose(
        ce_loss(tcfg, logits, torch.from_numpy(labels)).item(),
        float(jax_ce_loss(jcfg, jlog, jnp.asarray(labels))), rtol=1e-5)


def test_cast_params_changes_no_value_the_model_sees():
    """For each ported family: the cast tree gives bit-identical logits;
    the leaves read in fp32 (norm scales; Mamba2 A_log, D, dt_bias and the
    gated-norm scale) stay fp32."""
    for arch in (ARCH,) + SSM_ARCHS:
        jcfg, tcfg = _cfgs("bfloat16", arch)
        _, tp = _weights(jcfg, tcfg, seed=8)
        cast = tlm.cast_params(tcfg, tp, torch.bfloat16)
        layers = cast["layers"]
        if arch == ARCH:
            assert layers["ln1"].dtype == torch.float32
            assert layers["mlp"]["w1"].dtype == torch.bfloat16
        else:
            for n in ("A_log", "D", "dt_bias", "norm"):
                assert layers[n].dtype == torch.float32, n
            assert layers["wx"].dtype == torch.bfloat16
            assert layers["conv_x"].dtype == torch.bfloat16
        if "shared_attn" in cast:
            assert cast["shared_attn"]["ln1"].dtype == torch.float32
            assert cast["shared_attn"]["mlp"]["w1"].dtype == torch.bfloat16
        toks = torch.from_numpy(_tokens(tcfg, (2, 16), seed=8))
        a, _, _ = tlm.forward(tcfg, tp, {"tokens": toks})
        b, _, _ = tlm.forward(tcfg, cast, {"tokens": toks})
        assert torch.equal(a, b), arch


@pytest.mark.parametrize("arch", list_archs())
def test_forward_matches_jax_every_arch(arch):
    """Every architecture the JAX package registers, at smoke size in fp32
    (summation order only), from the same weights and tokens: logits and
    the aux loss (the moe family's; 0.0 elsewhere)."""
    jcfg, tcfg = _cfgs("float32", arch)
    jp, tp = _weights(jcfg, tcfg, seed=9)
    shape = (2, 32, tcfg.n_codebooks) if tcfg.n_codebooks else (2, 32)
    toks = _tokens(jcfg, shape, seed=9)
    jl, jaux, _ = jlm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, taux, _ = tlm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert tuple(tl.shape) == jl.shape
    _close(tl, jl, TOLS["float32"], arch)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-12)


def test_mla_training_on_a_card_tensor_raises_and_names_the_roadmap():
    """A deepseek-v2-lite train step off the CPU (parameters and batch on
    ``meta``: no card needed) no longer stops at a guard naming the
    ROADMAP, as the name still says: its first MLA
    attention reaches the flash forward kernel's wrapper, with lse for the
    backward, which takes CUDA tensors only and raises for ``meta``. On
    the card it trains through the (192, 128) backward kernel
    (``chip_smoke.py``); on the CPU through the plain versions
    (``test_torch_moe.py``)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    cfg = torch_smoke("deepseek-v2-lite-16b")
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    meta = tree_map(lambda t: t.to("meta"), params)
    t = torch.zeros((2, 16), dtype=torch.int32, device="meta")
    calls = []
    real = flash_ops.flash_attention_fwd
    flash_ops.flash_attention_fwd = \
        lambda *a, **kw: calls.append(kw.get("with_lse")) or real(*a, **kw)
    try:
        with pytest.raises(ValueError, match="CUDA"):
            loss_and_grads(cfg, meta, {"tokens": t, "labels": t})
    finally:
        flash_ops.flash_attention_fwd = real
    assert calls == [True]


def test_init_cache_needs_whole_pages():
    """Any k/v cache length is taken (36 here, not a multiple of the page
    size; the name is from when one was refused): the cache is allocated in whole pages and shows JAX's shapes,
    also after ``interop`` and ``grow_cache``; decode reads it in place
    as a page pool, and a position past the logical length is refused."""
    jcfg, tcfg = _cfgs("bfloat16")
    c = tlm.init_cache(tcfg, 36, 2, device="cpu")
    shape = (tcfg.n_layers, 2, 36, tcfg.n_kv_heads, tcfg.hd)
    jc = jlm.init_cache(jcfg, 36, 2)
    for n in ("k", "v"):
        assert tuple(c[n].shape) == shape == jc[n].shape
        assert c[n].untyped_storage().nbytes() == \
            2 * tcfg.n_layers * 2 * 48 * tcfg.n_kv_heads * tcfg.hd
        layer = c[n][0]
        pool = tlm.page_pool(layer, torch.bfloat16)
        assert pool.shape == (2 * 3, tlm.PAGE_SIZE, tcfg.n_kv_heads,
                              tcfg.hd)
        assert pool.data_ptr() == layer.data_ptr()     # in place
    carried = interop.cache_from_numpy(
        tcfg, {n: np.asarray(a) for n, a in jc.items()}, device="cpu")
    assert {n: tuple(t.shape) for n, t in carried.items()} == \
        {n: a.shape for n, a in jc.items()}
    grown = tlm.grow_cache(tcfg, {n: t[:, :, :20] for n, t in c.items()}, 36)
    assert tuple(grown["k"].shape) == shape
    params = tlm.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    with pytest.raises(ValueError, match="outside the cache"):
        tlm.decode_step(tcfg, params, c, torch.zeros((2, 1), dtype=torch.int32),
                        36)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "zamba2-2.7b"])
def test_generate_at_any_cache_length_equals_jax_serve_loop(arch):
    """A cache of 40 positions (two and a half pages): the port generates
    the JAX package's tokens, from a carried-over-shape cache the paged op
    reads in whole pages (dense, and hybrid's tied attention block)."""
    jcfg, tcfg = _cfgs("float32", arch)
    jp, tp = _weights(jcfg, tcfg, seed=2)
    prompt = _tokens(jcfg, (2, 12), seed=3)
    jgen = JaxServeLoop(jcfg, jp, max_len=40).generate(jnp.asarray(prompt), 4)
    tgen = ServeLoop(tcfg, tp, max_len=40, device="cpu").generate(prompt, 4)
    assert tuple(tgen.shape) == (2, 4)
    np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))


@pytest.mark.parametrize("arch", ["granite-34b", "yi-34b", "deepseek-67b"])
def test_generate_tokens_equal_jax_serve_loop_dense_archs(arch):
    """The generate-vs-JAX test over the other dense configs: granite-34b
    (MQA, 4 query heads over 1 KV head at smoke size, gelu MLP), yi-34b
    and deepseek-67b (GQA 4:1)."""
    jcfg, tcfg = _cfgs("float32", arch)
    jp, tp = _weights(jcfg, tcfg, seed=2)
    prompt = _tokens(jcfg, (2, 16), seed=3)
    jgen = JaxServeLoop(jcfg, jp, max_len=32).generate(jnp.asarray(prompt), 8)
    tgen = ServeLoop(tcfg, tp, max_len=32, device="cpu").generate(prompt, 8)
    assert tgen.dtype == torch.int32 and tuple(tgen.shape) == (2, 8)
    np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))


# ---------------------------------------------------------------------------
# ssm (mamba2-130m) and hybrid (zamba2-2.7b)
# ---------------------------------------------------------------------------

# port vs JAX, (atol, rtol): fp32 is summation order only. In bf16 the two
# packages round at other places, and through the smoke zamba2's four Mamba2
# layers and two attention blocks that reaches 0.14 on logits up to 4 (seed
# 3); JAX's own bf16 forward differs from its fp32 forward by 0.17 there.
SSM_TOLS = {"float32": (1e-4, 1e-4), "bfloat16": (2e-1, 5e-2)}
# prefill/decode consistency: tests/test_models.py:135 in bf16. In fp32 the
# decode caches still hold bf16 conv states (and bf16 k/v for hybrid): one
# bf16 rounding of those (2^-9 relative), carried through the layers,
# reaches 0.012 on logits up to 1.5 against the full fp32 forward.
CONSISTENCY_TOLS = {"float32": (2.5e-2, 1e-2), "bfloat16": (1e-1, 3e-2)}


def _ssm_close(t, j, tols, msg):
    np.testing.assert_allclose(_np(t), _np(j), atol=tols[0], rtol=tols[1],
                               err_msg=msg)


def _cache_tols(name, compute_dtype):
    """The fp32 ssm state at the compute tolerance; bf16 leaves (conv, k/v)
    at least at one bf16 rounding (tests/test_kernels.py:110)."""
    tols = SSM_TOLS[compute_dtype]
    if name == "ssm":
        return tols
    return tuple(max(t, TOLS["bfloat16"]) for t in tols)


def _jgrow(cache, full):
    """The JAX cache grown as ``lm.grow_cache`` grows the port's."""
    out = {}
    for n in full:
        if cache[n].shape == full[n].shape:
            out[n] = cache[n]
        else:
            sl = tuple(slice(0, s) for s in cache[n].shape)
            out[n] = full[n].at[sl].set(cache[n])
    return out


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_forward_and_prefill_cache_match_jax(arch, compute_dtype):
    jcfg, tcfg = _cfgs(compute_dtype, arch)
    jp, tp = _weights(jcfg, tcfg, seed=3)
    toks = _tokens(jcfg, (2, 40))                   # two chunks, padded
    jl, _, jst = jlm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, aux, tst = tlm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 40, tlm.padded_vocab(tcfg.vocab_size)) \
        and tl.dtype == tcfg.compute_dt() and aux == 0.0
    tols = SSM_TOLS[compute_dtype]
    _ssm_close(tl, jl, tols, "logits")
    # states come back without collect_cache (repro/models/lm.py:381)
    assert set(tst) == set(jst) == {"ssm", "conv_x", "conv_b", "conv_c"}
    for n in tst:
        assert tuple(tst[n].shape) == jst[n].shape, n
        _ssm_close(tst[n], jst[n], tols, n)

    jlast, jcache = jax_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    tlast, tcache = make_prefill_step(tcfg)(tp,
                                            {"tokens": torch.from_numpy(toks)})
    _ssm_close(tlast, jlast, tols, "last logits")
    assert set(tcache) == set(jcache)
    defs = tlm.cache_spec_defs(tcfg, 40, 2)
    assert set(tcache) == set(defs)
    for n in tcache:
        assert tuple(tcache[n].shape) == jcache[n].shape == defs[n].shape, n
        assert tcache[n].dtype == getattr(torch, defs[n].dtype), n
        _ssm_close(tcache[n], jcache[n], _cache_tols(n, compute_dtype), n)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_decode_step_matches_jax_on_carried_cache(arch, compute_dtype):
    jcfg, tcfg = _cfgs(compute_dtype, arch)
    jp, tp = _weights(jcfg, tcfg, seed=4)
    S0, max_len = 20, 32
    toks = _tokens(jcfg, (2, S0), seed=4)
    _, jcache = jax_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    full = _jgrow(jcache, jlm.init_cache(jcfg, max_len, 2))
    tcache = interop.cache_from_numpy(
        tcfg, {n: np.asarray(a) for n, a in full.items()}, device="cpu")
    nxt = _tokens(jcfg, (2, 1), seed=5)
    for step in range(2):                # the second step reads the first's
        jlog, full = jlm.decode_step(jcfg, jp, full, jnp.asarray(nxt),
                                     jnp.int32(S0 + step))
        tlog, tnew = tlm.decode_step(tcfg, tp, tcache,
                                     torch.from_numpy(nxt), S0 + step)
        assert tnew is tcache                   # updated in place
        _ssm_close(tlog, jlog, SSM_TOLS[compute_dtype],
                   f"logits, step {step}")
        assert set(tnew) == set(full)
        for n in tnew:
            assert tnew[n].dtype == getattr(torch, str(full[n].dtype)), n
            _ssm_close(tnew[n], full[n], _cache_tols(n, compute_dtype),
                       f"{n}, step {step}")
        nxt = np.array(jnp.argmax(jlog[:, :jcfg.vocab_size], -1),
                       np.int32)[:, None]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_generate_tokens_equal_jax_serve_loop(arch):
    jcfg, tcfg = _cfgs("float32", arch)
    jp, tp = _weights(jcfg, tcfg, seed=2)
    prompt = _tokens(jcfg, (2, 16), seed=3)
    jgen = JaxServeLoop(jcfg, jp, max_len=32).generate(jnp.asarray(prompt), 8)
    tgen = ServeLoop(tcfg, tp, max_len=32, device="cpu").generate(prompt, 8)
    assert tgen.dtype == torch.int32 and tuple(tgen.shape) == (2, 8)
    np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_prefill_decode_consistency(arch, compute_dtype):
    """Twin of tests/test_models.py::test_prefill_decode_consistency:
    prefill on 32 tokens, then decode steps (each an SSD chunk of one
    token) give the logits of one full forward over 36 tokens."""
    jcfg, tcfg = _cfgs(compute_dtype, arch)
    _, params = _weights(jcfg, tcfg, seed=7)
    S0, S1 = 32, 36
    toks = torch.from_numpy(_tokens(tcfg, (2, S1), seed=7))
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


def test_ssm_cache_layout():
    """ssm has no k/v (so no pages); hybrid has k/v for its
    n_layers / attn_every attention applications, of any length."""
    _, mcfg = _cfgs("bfloat16", "mamba2-130m")
    c = tlm.init_cache(mcfg, 36, 2, device="cpu")     # 36: no whole pages
    s = mcfg.ssm
    di, nh = s.d_inner(mcfg.d_model), s.n_heads(mcfg.d_model)
    assert set(c) == {"ssm", "conv_x", "conv_b", "conv_c"}
    assert c["ssm"].shape == (mcfg.n_layers, 2, nh, s.headdim, s.d_state)
    assert c["ssm"].dtype == torch.float32
    assert c["conv_x"].shape == (mcfg.n_layers, 2, s.d_conv - 1, di)
    assert c["conv_b"].dtype == torch.bfloat16
    _, zcfg = _cfgs("bfloat16", "zamba2-2.7b")
    G = zcfg.n_layers // zcfg.attn_every
    for S in (36, 48):                   # any length: whole pages inside
        c = tlm.init_cache(zcfg, S, 2, device="cpu")
        assert c["k"].shape == (G, 2, S, zcfg.n_kv_heads, zcfg.hd)
    assert c["ssm"].shape[0] == zcfg.n_layers
