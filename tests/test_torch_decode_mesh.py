"""Decode on a mesh, on the CPU: ``lm.decode_step(mesh=, rules=)`` with
the cache split along its sequence (``kv_seq``) over gloo ranks, each
rank attending over its shard through the paged op with lse and the
shards merged in fp32, against the port's ``mesh=None`` decode and the
JAX package's ``decode_step`` from the same numpy weights and carried
cache; and the merge itself against one softmax over the whole
sequence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import lm as jlm
from repro_torch.models import attention as attn

from test_torch_mesh import run_ranks

# mesh vs mesh=None: one step's sums in another order (fp32); the port
# against JAX: fp32 sums in other orders through every layer, as
# tests/test_torch_lm.py holds them. Two cases are held at
# tests/test_torch_mesh.py's fp32 mesh tolerance instead: the hybrid's SSM
# state carries each step's rounding into the next (measured: 5.1e-5 at
# the fourth step, 2e-5 until then), and mixtral's expert products sum
# their FSDP shards in another order (4.2e-5 at the first step)
SELF_TOL, JAX_TOL = 2e-5, 1e-4
# after the first step each path decodes over the K/V (ckv/kr) it wrote
# itself, rounded to bf16 from fp32 values that differ in their last
# bits: a cache entry one bf16 ulp apart moves the port's logits from
# JAX's (measured: 4.1e-4, deepseek-v2-lite, the fifth step)
LATER_JAX_TOL = 2e-3
SELF_TOLS = {"zamba2": 1e-4, "mixtral": 1e-4}
BF16_ULP = 2.0 ** -7
STEPS = 4
# name -> (arch, overrides, prompt S0, cache length, batch, wide_kv, mesh)
CASES = {
    # GQA (2 KV heads); the cache split over model (4 shards of 16)
    "stablelm": ("stablelm-1.6b", dict(n_kv_heads=2), 20, 64, 2, False,
                 (2, 4)),
    # SWA ring past its window of 64: prompt 62, decode to position 65,
    # the writes wrapping to slots 0 and 1 of shard 0
    "mixtral": ("mixtral-8x22b", {}, 62, 96, 2, False, (2, 4)),
    # hybrid: Mamba2 layers on their SSM heads, the tied block's cache split
    "zamba2": ("zamba2-2.7b", {}, 20, 64, 2, False, (2, 4)),
    # MLA (ckv/kr split on kv_seq) and MoE routed as one group
    "deepseek": ("deepseek-v2-lite-16b", {}, 20, 64, 2, False, (2, 4)),
    # batch 1: the sequence split over every axis (8 shards of 8), five
    # of them empty at the first step
    "wide_kv": ("stablelm-1.6b", {}, 20, 64, 1, True, (2, 4)),
}

SCRIPT = """
    from repro_torch import interop
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import lm
    CASES, STEPS = CASES_, STEPS_
    with np.load(os.path.join(OUT, "in.npz")) as f:
        inp = dict(f)

    def tree_from(prefix):
        out = {}
        for k in inp:
            if not k.startswith(prefix):
                continue
            node = out
            *head, leaf = k[len(prefix):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = inp[k]
        return out

    results = {}
    for name, (arch, ov, S0, L, B, wide, shape) in CASES.items():
        mesh = make_mesh(shape, ("data", "model"))
        cfg = get_smoke_config(arch).replace(compute_dtype="float32", **ov)
        params = interop.params_from_numpy(cfg, tree_from(name + "|p:"),
                                           device="cpu")
        defs = lm.cache_spec_defs(cfg, L, B)
        # bf16 leaves travel as fp32 (exactly) and are cast back
        cache = {n: t.to(getattr(torch, defs[n].dtype)) for n, t in
                 interop.cache_from_numpy(cfg, tree_from(name + "|c:"),
                                          device="cpu").items()}
        rules = part.rules_for(mesh, B, wide_kv=wide)
        paths = {"none": (params, {n: t.clone() for n, t in cache.items()},
                          None, None),
                 "mesh": (lm.place_params(cfg, params, mesh, rules),
                          {n: part.place(t.clone(), part.sharding_for(
                              defs[n].logical, mesh, rules))
                           for n, t in cache.items()}, mesh, rules)}
        with torch.no_grad():
            for path, (p, c, m, r) in paths.items():
                tok = torch.as_tensor(inp[name + "|tok"])
                for i in range(STEPS):
                    logits, c = lm.decode_step(cfg, p, c, tok, S0 + i,
                                               mesh=m, rules=r)
                    logits = part.full(logits)
                    results[f"{name}|{path}|logits{i}"] = logits.numpy()
                    tok = logits[..., :cfg.vocab_size].argmax(-1).to(
                        torch.int32)[:, None]
                for n, t in c.items():
                    results[f"{name}|{path}|cache:{n}"] = \\
                        part.full(t).float().numpy()
            # the serve step on the mesh: its next tokens as DTensors
            nxt, _ = make_serve_step(cfg, mesh, rules)(
                paths["mesh"][0], paths["mesh"][1],
                torch.as_tensor(inp[name + "|tok"]), S0 + STEPS)
            results[name + "|serve_tok"] = part.full(nxt).numpy()
    save(**results)
"""


def _flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        out[prefix + key] = np.asarray(leaf)
    return out


def _jax_case(name):
    """JAX's weights, its prefill cache carried into a cache of the case's
    length, the first token, and its greedy decode logits over STEPS."""
    arch, ov, S0, L, B, _, _ = CASES[name]
    cfg = jax_smoke(arch).replace(compute_dtype="float32", **ov)
    params = jlm.init_params(cfg, jax.random.PRNGKey(3))
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S0))
    logits0, pre = jax_prefill_step(cfg)(params, {
        "tokens": jnp.asarray(toks, jnp.int32)})
    cache = jlm.init_cache(cfg, L, B)
    for n in cache:
        if n in ("k", "v", "ckv", "kr"):
            cache[n] = cache[n].at[:, :, :pre[n].shape[2]].set(pre[n])
        else:
            cache[n] = pre[n].astype(cache[n].dtype)
    tok = np.asarray(jnp.argmax(logits0[..., :cfg.vocab_size], -1),
                     np.int32)[:, None]
    inputs = {**_flat(params, name + "|p:"),
              **_flat({n: np.asarray(a.astype(jnp.float32))
                       for n, a in cache.items()}, name + "|c:"),
              name + "|tok": tok}
    logits, t = [], jnp.asarray(tok)
    for i in range(STEPS):
        lg, cache = jlm.decode_step(cfg, params, cache, t, jnp.int32(S0 + i))
        logits.append(np.asarray(lg, np.float32))
        t = jnp.argmax(lg[..., :cfg.vocab_size], -1).astype(jnp.int32)[:,
                                                                        None]
    return inputs, logits


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    """Every case on 8 gloo ranks in one run (rank 0's results), and
    JAX's logits of each."""
    inputs, jax_logits = {}, {}
    for name in CASES:
        inp, jax_logits[name] = _jax_case(name)
        inputs.update(inp)
    script = SCRIPT.replace("CASES_", repr(CASES)).replace("STEPS_",
                                                           repr(STEPS))
    out = run_ranks(script, 8, tmp_path_factory.mktemp("decode"), inputs)
    return out, jax_logits


@pytest.mark.parametrize("name", list(CASES))
def test_decode_on_a_mesh_matches_mesh_none_and_jax(decoded, name):
    """Over STEPS greedy steps from JAX's carried prefill cache: the mesh
    decode's logits within SELF_TOL of mesh=None's (fp32) and its tokens
    equal; both within JAX_TOL of JAX's decode_step and the same greedy
    tokens; the caches after the steps equal (the writes landed where the
    shards hold them); the serve step runs on the mesh."""
    out, jax_logits = decoded
    V = jax_smoke(CASES[name][0]).vocab_size
    tol = SELF_TOLS.get(name, SELF_TOL)
    for i in range(STEPS):
        mesh, none = (out[f"{name}|{p}|logits{i}"] for p in ("mesh", "none"))
        np.testing.assert_allclose(mesh, none, atol=tol, rtol=tol,
                                   err_msg=f"step {i}")
        jtol = JAX_TOL if i == 0 else LATER_JAX_TOL
        np.testing.assert_allclose(none, jax_logits[name][i], atol=jtol,
                                   rtol=jtol, err_msg=f"jax step {i}")
        for a in (mesh, none):
            np.testing.assert_array_equal(
                a[..., :V].argmax(-1), jax_logits[name][i][..., :V].argmax(-1))
    for key in out:
        if key.startswith(f"{name}|mesh|cache:"):
            # a bf16 leaf may sit one bf16 ulp from the other path's
            np.testing.assert_allclose(
                out[key], out[key.replace("|mesh|", "|none|")],
                atol=tol, rtol=BF16_ULP, err_msg=key)
    assert out[f"{name}|serve_tok"].shape[:2] == (CASES[name][4], 1)


def test_merge_of_shards_is_one_softmax():
    """fp32 (o, lse) of a sequence's shards, one of them empty (the paged
    op's zero-length row: the mean of V, lse -1e30), merged: equal to the
    softmax over the whole sequence."""
    g = torch.Generator().manual_seed(0)
    B, H, hd, n = 2, 3, 8, 4
    S = 4 * n
    s = torch.randn((B, H, S), generator=g) * 3
    v = torch.randn((B, S, hd), generator=g)
    os, lses = [], []
    for r in range(4):
        lo, hi = r * n, (r + 1) * n
        if r == 2:                        # an empty shard
            os.append(v[:, lo:hi].mean(1)[:, None].expand(B, H, hd))
            lses.append(torch.full((B, H), -1e30))
            continue
        sr = s[..., lo:hi]
        os.append(torch.einsum("bhs,bsd->bhd", torch.softmax(sr, -1),
                               v[:, lo:hi]))
        lses.append(torch.logsumexp(sr, -1))
    s[..., 2 * n:3 * n] = -1e30           # the empty shard's positions
    whole = torch.einsum("bhs,bsd->bhd", torch.softmax(s, -1), v)
    got = attn.merge_shards(torch.stack(os), torch.stack(lses))
    torch.testing.assert_close(got, whole, atol=1e-6, rtol=1e-6)
    # merge_over with no group: the shard itself
    assert torch.equal(attn.merge_over(os[0], lses[0], []), os[0])
