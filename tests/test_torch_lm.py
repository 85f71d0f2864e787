"""The port's dense serving path against the JAX package on the CPU, with
JAX weights carried over through numpy (``repro_torch.interop``):
forward logits, the prefill cache, a decode step on a carried-over cache,
and greedy generation."""

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
from repro_torch.launch.steps import ce_loss, make_prefill_step
from repro_torch.models import lm as tlm
from repro_torch.serve import ServeLoop

ARCH = "stablelm-1.6b"
# fp32 compute: summation order only; bf16: tests/test_kernels.py:110
TOLS = {"float32": 1e-4, "bfloat16": 5e-2}


def _cfgs(compute_dtype):
    return (jax_smoke(ARCH).replace(compute_dtype=compute_dtype),
            torch_smoke(ARCH).replace(compute_dtype=compute_dtype))


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
    jcfg, tcfg = _cfgs("bfloat16")
    _, tp = _weights(jcfg, tcfg, seed=8)
    cast = tlm.cast_params(tcfg, tp, torch.bfloat16)
    assert cast["layers"]["ln1"].dtype == torch.float32
    assert cast["layers"]["mlp"]["w1"].dtype == torch.bfloat16
    toks = torch.from_numpy(_tokens(tcfg, (2, 16), seed=8))
    a, _, _ = tlm.forward(tcfg, tp, {"tokens": toks})
    b, _, _ = tlm.forward(tcfg, cast, {"tokens": toks})
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["mamba2-130m", "mixtral-8x22b",
                                  "qwen2-vl-2b", "musicgen-large"])
def test_other_families_raise_and_name_the_roadmap(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlm.param_defs(torch_smoke(arch))


def test_init_cache_needs_whole_pages():
    _, tcfg = _cfgs("bfloat16")
    with pytest.raises(ValueError, match="page"):
        tlm.init_cache(tcfg, 36, 2, device="cpu")
    c = tlm.init_cache(tcfg, 48, 2, device="cpu")
    assert c["k"].shape == (tcfg.n_layers, 2, 48, tcfg.n_kv_heads, tcfg.hd)
    params = tlm.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    with pytest.raises(ValueError, match="outside the cache"):
        tlm.decode_step(tcfg, params, c, torch.zeros((2, 1), dtype=torch.int32),
                        48)
