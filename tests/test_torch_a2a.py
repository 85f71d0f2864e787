"""The explicit all-to-all (``repro_torch.distributed.a2a``) on gloo ranks:
``a2a`` against the tiled all-to-all's definition (``jax.lax.all_to_all``
with ``tiled=True``: rank r's output is piece r of every rank's input
along ``split_axis``, joined along ``concat_axis`` in rank order), its
gradient (the all-to-all back), ``a2a_chunked`` against ``a2a``, and the
MoE dispatch/combine on DTensors. Each case runs in 4 processes of one
gloo group (``test_torch_mesh.run_ranks``)."""

import numpy as np
import pytest

from test_torch_mesh import run_ranks

WORLD = 4

A2A_SCRIPT = """
    from repro_torch.distributed.a2a import (a2a, a2a_chunked,
                                             moe_dispatch_combine)
    group = dist.group.WORLD
    shape = (8, 4, 12, 2)

    def x_of(r):                 # rank r's input, the same on every rank
        return torch.arange(np.prod(shape), dtype=torch.float32).reshape(
            shape) * (r + 1)

    x = x_of(RANK).requires_grad_(True)
    out = {}
    for split, concat in ((0, 1), (2, 1), (1, 3), (2, 2)):
        y = a2a(x, group, split_axis=split, concat_axis=concat)
        want = torch.cat([torch.chunk(x_of(i), WORLD, dim=split)[RANK]
                          for i in range(WORLD)], dim=concat)
        assert torch.equal(y, want), (split, concat)
        yc = a2a_chunked(x, group, split_axis=split, concat_axis=concat,
                         n_chunks=2, chunk_axis=3 if 3 not in (split, concat)
                         else 0)
        assert torch.equal(yc, y), (split, concat)
        # the gradient of a sum weighted by a rank-known cotangent
        cot = torch.arange(y.numel(), dtype=torch.float32).reshape(
            y.shape) + 100 * RANK
        (gx,) = torch.autograd.grad((y * cot).sum(), x)
        back = a2a(cot, group, split_axis=concat, concat_axis=split)
        assert torch.equal(gx, back), (split, concat)
        out[f"y {split} {concat}"] = y.detach().numpy()

    # dispatch/combine on a (1, 4) mesh: G group-sharded <-> E expert-sharded
    mesh = make_mesh((1, WORLD), ("data", "model"))
    B, G, E, C, D = 2, 8, 4, 3, 5
    xs = torch.arange(B * G * E * C * D, dtype=torch.float32).reshape(
        B, G, E, C, D)
    xg = part.place(xs, part.sharding_for(("batch", "act_seq"), mesh))
    for n_chunks in (1, 3):
        dispatch, combine = moe_dispatch_combine(mesh, ("data",),
                                                 n_chunks=n_chunks)
        xe = dispatch(xg)
        assert [str(p) for p in xe.placements] == ["S(0)", "S(2)"], \\
            xe.placements
        assert torch.equal(xe.full_tensor(), xs)
        assert torch.equal(combine(xe).full_tensor(), xs)
        local = xe.to_local()
        assert local.shape == (B, G, E // WORLD, C, D)
    out["xe local"] = local.numpy()
    save(**out)
"""


def test_a2a_semantics_gradient_and_dispatch(tmp_path):
    """On 4 gloo ranks: ``a2a`` at four (split, concat) pairs equals the
    tiled all-to-all's definition, ``a2a_chunked`` equals it, its gradient
    is the all-to-all back, and dispatch/combine move a (B, G, E, C, D)
    DTensor between group- and expert-sharded layouts without changing a
    value (1 and 3 chunks)."""
    out = run_ranks(A2A_SCRIPT, WORLD, tmp_path)
    shape = (8, 4, 12, 2)
    x = [np.arange(np.prod(shape), dtype=np.float32).reshape(shape) * (i + 1)
         for i in range(WORLD)]
    # rank 0's output at (split 0, concat 1): piece 0 of every rank's x
    want = np.concatenate([np.split(xi, WORLD, axis=0)[0] for xi in x],
                          axis=1)
    np.testing.assert_array_equal(out["y 0 1"], want)
    xs = np.arange(2 * 8 * 4 * 3 * 5, dtype=np.float32).reshape(2, 8, 4, 3, 5)
    np.testing.assert_array_equal(out["xe local"], xs[:, :, :1])


def test_a2a_refuses_an_axis_that_does_not_split(tmp_path):
    script = """
    from repro_torch.distributed.a2a import a2a
    try:
        a2a(torch.zeros(6, 2), dist.group.WORLD, split_axis=0,
            concat_axis=1)
    except ValueError:
        save(ok=np.int64(1))
    """
    assert int(run_ranks(script, WORLD, tmp_path)["ok"]) == 1


@pytest.mark.parametrize("n_chunks", [1, 2])
def test_moe_ffn_shard_map_gradient_matches_gshard(tmp_path, n_chunks):
    """The MoE layer's gradient through the explicit all-to-all equals its
    gradient through the constraint flips, on a (2, 2) mesh in fp32 (the
    smoke mixtral layer, 16 sub-experts, S = 1024: G = 16); the dispatch
    in ``n_chunks`` pieces gives the same."""
    script = f"""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import a2a as a2a_mod
    from repro_torch.models import lm, moe
    mesh = make_mesh((2, 2), ("data", "model"))
    cfg = get_smoke_config("mixtral-8x22b").replace(compute_dtype="float32")
    p = {{k: v[0] for k, v in lm.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
        ["layers"]["moe"].items()}}
    x = torch.randn(4, 1024, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    rules = part.rules_for(mesh, 4)
    xd = part.place(x, part.sharding_for(("batch", "act_seq", None), mesh,
                                         rules))
    defs = moe.moe_defs(cfg)
    pd = {{k: part.place(v, part.sharding_for(defs[k].logical, mesh,
                                              rules))
          for k, v in p.items()}}
    orig = a2a_mod.moe_dispatch_combine
    a2a_mod.moe_dispatch_combine = lambda m, b, n_chunks=1: orig(
        m, b, n_chunks={n_chunks})
    res = {{}}
    for impl in ("gshard", "shard_map"):
        c = cfg.replace(moe_impl=impl)
        leaves = {{k: v.detach().requires_grad_(True) for k, v in pd.items()}}
        xi = xd.detach().requires_grad_(True)
        y, aux = moe.moe_ffn(c, leaves, xi, torch.float32, mesh=mesh,
                             rules=rules)
        loss = (y * y).mean() + aux
        grads = torch.autograd.grad(loss, [xi] + list(leaves.values()))
        res[impl] = [part.full(g).numpy() for g in grads] + \\
            [part.full(y).detach().numpy()]
    for a, b in zip(res["gshard"], res["shard_map"]):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)
    save(n=np.int64(len(res["gshard"])))
    """
    assert int(run_ranks(script, WORLD, tmp_path)["n"]) > 2
