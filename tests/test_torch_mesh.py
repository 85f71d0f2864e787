"""The port's mesh path on the CPU: the partitioning rules against the JAX
package's, entry for entry, for every registered config; DTensor
placements; the production meshes over a fake process group; and the
sharded train and prefill steps in several processes over gloo (one
thread a rank, a ``FileStore`` in a temporary directory, each process
with its own timeout), against the JAX package's single-device step on
the same numpy weights and against the port's own ``mesh=None`` step.

``run_ranks`` (the multi-process harness) is shared with
``test_torch_a2a.py``."""

import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.configs import list_archs
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import lm as jlm
from repro.models import partitioning as jpart
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import SHAPES
from repro_torch.configs import get_config as torch_config
from repro_torch.launch.steps import shardings_for_cell
from repro_torch.models import lm
from repro_torch.models import partitioning as part
from repro_torch.tree import tree_leaves

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
# each rank's own limit (the JAX package's multi-device test allows 600 s)
RANK_TIMEOUT = 600

# Every rank runs PRELUDE, then its test's script: the gloo group over a
# FileStore (no port, so xdist workers cannot collide), one thread a rank.
PRELUDE = textwrap.dedent("""
    import logging, os, sys, warnings
    warnings.filterwarnings("ignore")
    logging.disable(logging.WARNING)
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    RANK, WORLD, STORE, OUT = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", store=dist.FileStore(STORE, WORLD),
                            rank=RANK, world_size=WORLD)
    from repro_torch.models import partitioning as part
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.tree import tree_leaves, tree_map

    # The card's torch (2.11) refuses to view (B, S, D) as (B*S, D) when S
    # is split (a matmul's flatten); later versions split the result
    # strided instead. The ranks refuse it too, as the card would.
    from torch.distributed.tensor._ops import _view_ops
    from torch.distributed.tensor.placement_types import _StridedShard
    _propagate = _view_ops.propagate_shape_and_sharding

    def _as_on_the_card(src, *args, **kwargs):
        tgt, out = _propagate(src, *args, **kwargs)
        strided = [isinstance(p, _StridedShard) for p in (*src, *out)]
        if any(strided[len(src):]) and not any(strided[:len(src)]):
            raise RuntimeError(f"a view flattens a split non-first dim: "
                               f"{src} -> {out}")
        return tgt, out
    _view_ops.propagate_shape_and_sharding = _as_on_the_card

    def save(**arrays):          # rank 0's results, for the test to read
        if RANK == 0:
            np.savez(os.path.join(OUT, "out.npz"), **arrays)

    def whole(tree):             # every leaf's whole value, as numpy
        return [part.full(t).detach().float().numpy()
                for t in tree_leaves(tree)]
""")
EPILOGUE = "\ndist.destroy_process_group()\nprint('RANK_OK')\n"


def run_ranks(script, world, tmp_path, inputs=None):
    """Runs PRELUDE + ``script`` in ``world`` processes (ranks of one gloo
    group); ``inputs`` (arrays) are saved to ``in.npz`` beside them.
    Returns rank 0's ``out.npz`` (a dict of arrays)."""
    tmp_path = pathlib.Path(tmp_path)
    path = tmp_path / "ranks.py"
    path.write_text(PRELUDE + textwrap.dedent(script) + EPILOGUE)
    if inputs is not None:
        np.savez(tmp_path / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(path), str(r), str(world),
         str(tmp_path / "store"), str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, out, err) in enumerate(results):
        assert rc == 0 and "RANK_OK" in out, \
            f"rank {r} rc={rc}\n{out[-2000:]}\n{err[-4000:]}"
    with np.load(tmp_path / "out.npz") as f:
        return dict(f)


# ---------------------------------------------------------------------------
# The rules against JAX's (shape only: stand-in meshes)
# ---------------------------------------------------------------------------

class FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


MESHES = [FakeMesh((16, 16), ("data", "model")),
          FakeMesh((2, 16, 16), ("pod", "data", "model"))]
RULE_SETS = [(gb, wide) for gb in (1, 8, 256) for wide in (False, True)]


def _defs(tree, prefix=""):
    """{path: ParamDef} of a nested dict of either package's ParamDefs."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_defs(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _config_pairs(arch):
    """The JAX and port configs of ``arch``, and for moe archs the
    ``moe_fsdp_out`` layout too."""
    pairs = [(jax_config(arch), torch_config(arch))]
    if pairs[0][0].moe is not None:
        pairs.append((pairs[0][0].replace(moe_fsdp_out=True),
                      pairs[0][1].replace(moe_fsdp_out=True)))
    return pairs


def _all_defs(jcfg, tcfg):
    """(JAX defs, port defs) of the parameters and of decode caches."""
    out = [(jlm.param_defs(jcfg), lm.param_defs(tcfg))]
    for max_len, batch in ((4096, 8), (32_768, 1)):
        out.append((jlm.cache_spec_defs(jcfg, max_len, batch),
                    lm.cache_spec_defs(tcfg, max_len, batch)))
    return out


def spec_of(placements, mesh, ndim):
    """The partition spec that DTensor ``placements`` express (the inverse
    of ``placements_for``)."""
    from torch.distributed.tensor import Shard
    per_dim = [[] for _ in range(ndim)]
    for a, p in zip(part.axis_sizes(mesh), placements):
        if isinstance(p, Shard):
            per_dim[p.dim].append(a)
    return tuple(None if not axes else axes[0] if len(axes) == 1
                 else tuple(axes) for axes in per_dim)


@pytest.mark.parametrize("arch", list_archs())
def test_spec_for_matches_jax_for_every_leaf(arch):
    """Every parameter and cache leaf of every registered config, at both
    production meshes and six rule sets: the port's spec equals JAX's
    PartitionSpec entry for entry, and ``shardings_for_cell`` places each
    parameter by it."""
    n = 0
    for jcfg, tcfg in _config_pairs(arch):
        for jdefs, tdefs in _all_defs(jcfg, tcfg):
            jd, td = _defs(jdefs), _defs(tdefs)
            assert list(jd) == list(td)
            for mesh in MESHES:
                for gb, wide in RULE_SETS:
                    jr = jpart.rules_for(mesh, gb, wide_kv=wide)
                    tr = part.rules_for(mesh, gb, wide_kv=wide)
                    assert jr == tr
                    for path, pd in td.items():
                        assert pd.shape == jd[path].shape, path
                        want = tuple(jpart.spec_for(jd[path].logical, mesh,
                                                    jr))
                        assert part.spec_for(pd.logical, mesh, tr) == want, \
                            (arch, path, mesh.shape, gb, wide)
                        n += 1
    assert n > 0
    for mesh in MESHES:
        cell = shardings_for_cell(torch_config(arch), SHAPES["train_4k"],
                                  mesh)
        jd = _defs(jlm.param_defs(jax_config(arch)))
        for path, sh in _defs(cell["params_sh"]).items():
            want = tuple(jpart.spec_for(jd[path].logical, mesh,
                                        cell["rules"]))
            assert spec_of(sh.placements, mesh, len(want)) == want
        assert all(t.device.type == "meta"
                   for t in _defs(cell["params_abs"]).values())


@pytest.mark.parametrize("arch", list_archs())
def test_placements_round_trip(arch):
    """``placements_for`` gives placements that express each spec."""
    tcfg = torch_config(arch)
    for mesh in MESHES:
        for gb, wide in RULE_SETS:
            rules = part.rules_for(mesh, gb, wide_kv=wide)
            for defs in (lm.param_defs(tcfg),
                         lm.cache_spec_defs(tcfg, 4096, gb)):
                for pd in _defs(defs).values():
                    spec = part.spec_for(pd.logical, mesh, rules)
                    pl = part.placements_for(spec, mesh)
                    assert len(pl) == len(mesh.axis_names)
                    assert spec_of(pl, mesh, len(spec)) == spec


def test_placements_refuse_axes_out_of_mesh_order():
    mesh = MESHES[1]
    with pytest.raises(ValueError):
        part.placements_for((("data", "pod"), None), mesh)
    with pytest.raises(ValueError):
        part.placements_for(("model", "model"), mesh)


def test_partitioning_rules():
    """The twin of tests/test_roofline.py's test_partitioning_rules."""
    local = FakeMesh((1, 1), ("data", "model"))
    assert part.spec_for(("embed", "mlp"), local) == ("data", "model")
    assert part.spec_for(("kv_heads",), local) == (None,)
    fake = MESHES[0]
    assert part.batch_axes_for(1, fake) == ()       # batch=1 can't shard
    assert part.batch_axes_for(256, fake) == ("data",)
    assert part.batch_axes_for(8, fake) == ()       # 8 % 16 != 0
    r = part.rules_for(fake, 1, wide_kv=True)
    assert r["batch"] == ()
    assert "model" in r["kv_seq"]


def test_input_defs_match_jax():
    for arch in list_archs():
        for shape in SHAPES.values():
            want = jlm.input_defs(jax_config(arch), shape)
            got = lm.input_defs(torch_config(arch), shape)
            assert got == want, (arch, shape.name)


def test_abstract_trees_are_meta_with_jax_shapes():
    for arch in list_archs():
        jcfg, tcfg = jax_config(arch), torch_config(arch)
        want = jax.tree_util.tree_leaves(jlm.abstract_params(jcfg))
        got = tree_leaves(lm.abstract_params(tcfg))
        assert [tuple(s.shape) for s in want] == \
            [tuple(t.shape) for t in got]
        assert [str(s.dtype) for s in want] == \
            [str(t.dtype).replace("torch.", "") for t in got]
        assert all(t.device.type == "meta" for t in got)
        cache = _defs(lm.abstract_cache(tcfg, 4096, 8))
        jcache = jlm.abstract_cache(jcfg, 4096, 8)
        assert {k: tuple(t.shape) for k, t in cache.items()} == \
            {k: tuple(s.shape) for k, s in jcache.items()}


# ---------------------------------------------------------------------------
# Production meshes over a fake process group
# ---------------------------------------------------------------------------

FAKE_PG = textwrap.dedent("""
    import sys
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = int(sys.argv[1])
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=world == 512)
    print("MESH", mesh.mesh_dim_names, tuple(mesh.shape))
    dist.destroy_process_group()
""")
JAX_MESH = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    from repro.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=sys.argv[1] == "512")
    print("MESH", tuple(mesh.axis_names), tuple(mesh.devices.shape))
""")


@pytest.mark.parametrize("world", [256, 512])
def test_production_mesh_over_fake_process_group(world):
    """``make_production_mesh`` over a fake group of 256 / 512 ranks has
    the JAX package's axis names and sizes (JAX's built over 512 forced
    host devices), each in its own process."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    lines = []
    for script in (FAKE_PG, JAX_MESH):
        r = subprocess.run([sys.executable, "-c", script, str(world)],
                           env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        lines.append([ln for ln in r.stdout.splitlines()
                      if ln.startswith("MESH")][0])
    assert lines[0] == lines[1]


def test_mesh_module_touches_no_process_group():
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        mesh_mod.make_local_mesh()


# ---------------------------------------------------------------------------
# The op guard: a DTensor never reaches a kernel op
# ---------------------------------------------------------------------------

def test_kernel_ops_refuse_dtensors(tmp_path):
    """Each kernel op (flash, paged, SSD, and the autograd functions that
    carry the kernels) raises on a DTensor, on any device type: pinned
    here on the CPU over a one-rank gloo mesh, with no plain fallback."""
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attn import ops as paged_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.mesh import make_local_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_local_mesh()

        def d(*shape):
            return part.replicate(torch.randn(*shape), mesh)
        q, k, v = d(1, 16, 2, 8), d(1, 16, 2, 8), d(1, 16, 2, 8)
        calls = [
            lambda: flash_ops.flash_attention(q, k, v),
            lambda: flash_ops.FlashAttention.apply(q, k, v, True, 0, 1.0,
                                                   16, 0, "triangular"),
            lambda: paged_ops.paged_attention(
                d(1, 2, 8), d(2, 16, 2, 8), d(2, 16, 2, 8),
                torch.zeros((1, 2), dtype=torch.int32),
                torch.ones(1, dtype=torch.int32)),
            lambda: ssd_ops.ssd(d(1, 16, 2, 4), d(1, 16, 2), d(2),
                                d(1, 16, 4), d(1, 16, 4), d(2), chunk=8),
            lambda: ssd_ops.SSDChunk.apply(d(1, 16, 2, 4), d(1, 16, 2),
                                           d(2), d(1, 16, 4), d(1, 16, 4),
                                           8),
        ]
        for call in calls:
            with pytest.raises(TypeError, match="DTensor"):
                call()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The sharded train step: the twin of tests/test_multidevice.py
# ---------------------------------------------------------------------------

# the JAX test's tiny stablelm, and its tolerances against JAX's
# single-device step (loss 2e-2 absolute; params atol/rtol 5e-2)
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
            d_ff=128, vocab_size=256)
JAX_LOSS_TOL, JAX_PARAM_TOL = 2e-2, 5e-2
# the port's (2, 4) step against its own mesh=None step, bf16 compute as
# the JAX test's config: the sharded products sum their pieces in another
# order, and bf16 rounds the activations after them (measured on this
# config: loss 3.6e-5 relative, grad norm 1.7e-3 relative, params 6.0e-6
# after one AdamW step at its first lr, 3e-6; JAX's step is 1.4e-3 from
# the port's loss and 6.0e-6 from its params); the grad norm is the
# sensitive one, since one step at that lr moves no parameter further
SELF_TOLS = {"bfloat16": (1e-3, 1e-2, 1e-4),
             # fp32: only the order of the sums differs (measured: loss 0,
             # grad norm 1.2e-7, params 9.7e-8)
             "float32": (1e-6, 1e-6, 1e-6)}     # loss, grad norm, params

TRAIN_SCRIPT = """
    from repro_torch import interop
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.distributed.a2a import moe_dispatch_combine
    mesh = make_mesh((2, 4), ("data", "model"))
    with np.load(os.path.join(OUT, "in.npz")) as f:
        inp = dict(f)
    names = sorted(k for k in inp if k.startswith("p:"))

    # --- the all-to-all dispatch/combine round trip -----------------------
    x = torch.arange(2 * 4 * 4 * 3 * 5, dtype=torch.float32).reshape(
        2, 4, 4, 3, 5)
    xg = part.place(x, part.sharding_for(("batch", "act_seq"), mesh))
    dispatch, combine = moe_dispatch_combine(mesh, ("data",))
    xe = dispatch(xg)
    back = combine(xe).full_tensor()
    xe_sum = float(xe.full_tensor().sum())

    def tree_from(prefix):
        flat = {k[len(prefix):]: inp[k] for k in inp if k.startswith(prefix)}
        out = {}
        for path, a in flat.items():
            node = out
            *head, leaf = path.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = a
        return out

    results = {"back": back.numpy(), "xe_sum": np.float64(xe_sum)}
    for dtype in ("bfloat16", "float32"):
        cfg = get_smoke_config("stablelm-1.6b").replace(
            **TINY, compute_dtype=dtype)
        params = interop.params_from_numpy(cfg, tree_from("p:"),
                                           device="cpu")
        toks = torch.as_tensor(inp["tokens"])
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
        rules = part.rules_for(mesh, 4)
        p_ref = tree_map(lambda t: t.clone(), params)
        p_ref, _, m_ref = make_train_step(cfg)(p_ref, adamw_init(p_ref),
                                               batch)
        p_s = lm.place_params(cfg, params, mesh, rules)
        p_s, _, m_s = make_train_step(cfg, mesh, rules)(
            p_s, adamw_init(p_s), batch)
        results[f"{dtype} loss_mesh"] = np.float64(float(part.full(
            m_s["loss"])))
        results[f"{dtype} loss_none"] = np.float64(float(m_ref["loss"]))
        results[f"{dtype} gnorm_mesh"] = np.float64(float(part.full(
            m_s["grad_norm"])))
        results[f"{dtype} gnorm_none"] = np.float64(float(
            m_ref["grad_norm"]))
        for i, (a, b) in enumerate(zip(whole(p_s), whole(p_ref))):
            results[f"{dtype} mesh {i}"] = a
            results[f"{dtype} none {i}"] = b
    save(**results)
""".replace("TINY", repr(TINY))


def _jax_tree_to_flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        out[prefix + key] = np.asarray(leaf)
    return out


def test_sharded_train_step_matches_jax_and_mesh_none(tmp_path):
    """The twin of tests/test_multidevice.py: 8 gloo ranks on a (2, 4)
    ("data", "model") mesh. The a2a dispatch/combine round trip gives x
    back (and keeps its sum); the sharded train step of the JAX test's
    tiny stablelm equals JAX's single-device step from the same numpy
    weights and batch at JAX's own tolerance, and the port's mesh=None
    step at a tighter one."""
    cfg = jax_smoke("stablelm-1.6b").replace(**TINY)
    key = jax.random.PRNGKey(0)
    params = jlm.init_params(cfg, key)
    toks = jax.random.randint(key, (4, 32), 0, cfg.vocab_size)
    batch = {"tokens": toks, "labels": jnp.roll(toks, -1, 1)}
    p_ref, _, m_ref = jax.jit(jax_train_step(cfg))(
        params, jax_adamw_init(params), batch)
    inputs = _jax_tree_to_flat(params, "p:")
    inputs["tokens"] = np.asarray(toks)
    out = run_ranks(TRAIN_SCRIPT, 8, tmp_path, inputs)

    x = np.arange(2 * 4 * 4 * 3 * 5, dtype=np.float32).reshape(2, 4, 4, 3, 5)
    np.testing.assert_array_equal(out["back"], x)
    np.testing.assert_allclose(out["xe_sum"], x.sum())

    assert abs(float(m_ref["loss"]) - out["bfloat16 loss_mesh"]) \
        < JAX_LOSS_TOL
    jleaves = jax.tree_util.tree_leaves(p_ref)
    for i, a in enumerate(jleaves):
        np.testing.assert_allclose(out[f"bfloat16 mesh {i}"],
                                   np.asarray(a, np.float32),
                                   atol=JAX_PARAM_TOL, rtol=JAX_PARAM_TOL)
    for dtype, (lt, gt, pt) in SELF_TOLS.items():
        np.testing.assert_allclose(out[f"{dtype} loss_mesh"],
                                   out[f"{dtype} loss_none"], rtol=lt)
        np.testing.assert_allclose(out[f"{dtype} gnorm_mesh"],
                                   out[f"{dtype} gnorm_none"], rtol=gt)
        for i in range(len(jleaves)):
            np.testing.assert_allclose(out[f"{dtype} mesh {i}"],
                                       out[f"{dtype} none {i}"], atol=pt,
                                       rtol=0)


# ---------------------------------------------------------------------------
# The mesh paths of the modules: MoE (both dispatches), sp_norm,
# moe_fsdp_out, padded heads, the hybrid prefill, elastic restore
# ---------------------------------------------------------------------------

# fp32 compute: the sharded products only sum in another order (measured
# on these smoke configs: logits <= 1.2e-5 absolute, losses <= 7e-8
# relative, grad norms <= 1.9e-7 relative, params after one AdamW step
# <= 7.4e-7; the decode caches below)
MESH_F32_ATOL, MESH_F32_LOSS_RTOL, MESH_F32_PARAM_ATOL = 1e-4, 1e-6, 1e-5
# the decode cache is bf16: an fp32 value a few 1e-7 away may round to the
# neighbouring bf16 value (one ulp, 2^-7 relative)
BF16_ULP = 2.0 ** -7

STEPS_SCRIPT = """
    import json
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.distributed import a2a as a2a_mod
    spec = json.loads(open(os.path.join(OUT, "spec.json")).read())
    mesh = make_mesh(tuple(spec["mesh"]), ("data", "model"))
    calls = {"a2a": 0}
    inner = a2a_mod._a2a

    def counted(*a, **k):
        calls["a2a"] += 1
        return inner(*a, **k)
    a2a_mod._a2a = counted
    results = {}
    for name, over in spec["variants"].items():
        cfg = get_smoke_config(spec["arch"]).replace(
            compute_dtype="float32", **over)
        params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        g = torch.Generator().manual_seed(1)
        B, S = 4, spec["seq"]
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
        rules = part.rules_for(mesh, B)
        use_mesh = name != "none"
        placed = lm.place_params(cfg, params, mesh, rules) if use_mesh \\
            else params
        logits, cache = make_prefill_step(
            cfg, mesh if use_mesh else None, rules)(placed, batch)
        results[f"{name} logits"] = part.full(logits).numpy()
        for k, t in sorted(cache.items()):
            results[f"{name} cache {k}"] = part.full(t).float().numpy()
        if spec["train"]:
            p = tree_map(lambda t: t.clone(), placed)
            before = calls["a2a"]
            p, _, m = make_train_step(cfg, mesh if use_mesh else None,
                                      rules)(p, adamw_init(p), batch)
            results[f"{name} a2a"] = np.int64(calls["a2a"] - before)
            results[f"{name} loss"] = np.float64(float(part.full(m["loss"])))
            results[f"{name} gnorm"] = np.float64(float(part.full(
                m["grad_norm"])))
            for i, a in enumerate(whole(p)):
                results[f"{name} param {i}"] = a
    save(**results)
"""


def _run_steps(tmp_path, arch, mesh, seq, variants, train=True):
    import json
    (tmp_path / "spec.json").write_text(json.dumps(dict(
        arch=arch, mesh=mesh, seq=seq, variants=variants, train=train)))
    return run_ranks(STEPS_SCRIPT, mesh[0] * mesh[1], tmp_path)


def _assert_same(out, a, b, train=True):
    keys = [k[len(a) + 1:] for k in out if k.startswith(a + " ")
            and not k.endswith(" a2a")]
    assert keys
    for k in keys:
        x, y = out[f"{a} {k}"], out[f"{b} {k}"]
        if k in ("loss", "gnorm"):
            np.testing.assert_allclose(x, y, rtol=MESH_F32_LOSS_RTOL)
        elif k.startswith("param"):
            np.testing.assert_allclose(x, y, atol=MESH_F32_PARAM_ATOL,
                                       rtol=0)
        elif k.startswith("cache"):
            np.testing.assert_allclose(x, y, atol=MESH_F32_ATOL,
                                       rtol=BF16_ULP)
        else:
            np.testing.assert_allclose(x, y, atol=MESH_F32_ATOL, rtol=0)


def test_moe_shard_map_matches_constraint_path_and_mesh_none(tmp_path):
    """A smoke moe model (deepseek-v2-lite's: MLA, 8 experts split in 16,
    2 shared, a dense layer first) at S = 1024, so G = 16 groups, on a
    (1, 4) gloo mesh in fp32: ``moe_impl="shard_map"`` (the explicit
    all-to-all, two a2a calls a MoE layer forward and two back) against
    the constraint path and against mesh=None, prefill and a train
    step."""
    out = _run_steps(tmp_path, "deepseek-v2-lite-16b", (1, 4), 1024, {
        "none": {}, "gshard": {}, "shard_map": {"moe_impl": "shard_map"}})
    n_moe = 2              # the smoke config's MoE layers
    assert int(out["shard_map a2a"]) == 4 * n_moe
    assert int(out["gshard a2a"]) == 0
    _assert_same(out, "shard_map", "gshard")
    _assert_same(out, "shard_map", "none")
    _assert_same(out, "gshard", "none")


def test_sp_norm_and_moe_fsdp_out_change_no_value(tmp_path):
    """``sp_norm`` (two more constraints a block) and ``moe_fsdp_out``
    (the experts' FFN dim on ``data``) on a (2, 2) mesh: the same prefill
    and train step as the default layout and as mesh=None."""
    out = _run_steps(tmp_path, "mixtral-8x22b", (2, 2), 1024, {
        "none": {}, "default": {}, "sp_norm": {"sp_norm": True},
        "fsdp_out": {"moe_fsdp_out": True}})
    for name in ("sp_norm", "fsdp_out"):
        _assert_same(out, name, "default")
        _assert_same(out, name, "none")


def test_padded_heads_match_mesh_none(tmp_path):
    """12 query heads over 2 KV heads (qwen2-vl-2b's) on a (1, 8) mesh,
    where 8 does not divide 12: K/V expanded to the 12 heads, all padded
    to 16, sliced back (``repro/models/lm.py:198-215``), equal to
    mesh=None."""
    out = _run_steps(tmp_path, "qwen2-vl-2b", (1, 8), 64, {
        "none": {"n_heads": 12, "n_kv_heads": 2},
        "mesh": {"n_heads": 12, "n_kv_heads": 2}})
    _assert_same(out, "mesh", "none")


def test_query_heads_across_kv_groups_match_mesh_none(tmp_path):
    """12 query heads over 2 KV heads on a (1, 3) mesh: each rank's 4 query
    heads straddle two GQA groups of 6, so each takes one KV head a query
    head (the one path where the ranks' heads do not line up with whole
    groups or parts of one), equal to mesh=None."""
    out = _run_steps(tmp_path, "qwen2-vl-2b", (1, 3), 64, {
        "none": {"n_heads": 12, "n_kv_heads": 2},
        "mesh": {"n_heads": 12, "n_kv_heads": 2}})
    _assert_same(out, "mesh", "none")


SERVE_SCRIPT = """
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.serve import ServeLoop
    mesh = make_mesh((2, 2), ("data", "model"))
    cfg = get_smoke_config("zamba2-2.7b").replace(compute_dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (4, 32),
                           generator=torch.Generator().manual_seed(2))
    toks = {}
    for name, m in (("mesh", mesh), ("none", None)):
        loop = ServeLoop(cfg, params, max_len=48, mesh=m,
                         rules=part.rules_for(mesh, 4), device="cpu")
        toks[name] = loop.generate(prompt, 8).numpy()
    save(**toks)
"""


def test_serve_loop_prefills_on_the_mesh(tmp_path):
    """``ServeLoop(mesh=, rules=)`` on a (2, 2) mesh (the smoke zamba2, fp32
    compute): the prefill runs on the mesh and decode on the whole
    values, as the JAX package's loop; its greedy tokens equal those of
    the loop without a mesh."""
    out = run_ranks(SERVE_SCRIPT, 4, tmp_path)
    assert out["mesh"].shape == (4, 8)
    np.testing.assert_array_equal(out["mesh"], out["none"])


COUNT_SCRIPT = """
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import lm
    from repro_torch.observe import spans
    cfg = get_smoke_config("deepseek-v2-lite-16b").replace(
        compute_dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    B, S = 2, 1024
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(1))
    mesh = make_mesh((1, WORLD), ("data", "model"))
    rules = part.rules_for(mesh, B)
    counts = {}
    for name, m in (("none", None), ("mesh", mesh)):
        placed = params if m is None else \\
            lm.place_params(cfg, params, m, rules)
        spans.enable()
        make_prefill_step(cfg, m, None if m is None else rules)(
            placed, {"tokens": toks})
        c = spans.take()[1]
        spans.disable()
        counts[name] = torch.tensor([c["moe_kept_slots"], c["moe_slots"]])
    rank = counts["mesh"].clone()
    dist.all_reduce(counts["mesh"])
    save(none=counts["none"].numpy(), rank=rank.numpy(),
         total=counts["mesh"].numpy())
"""


def test_moe_counters_count_each_ranks_groups(tmp_path):
    """With the recorder on, a prefill on a (1, 2) mesh at S = 1024 (16
    groups, 8 a rank) counts on each rank its own groups' slots, and the
    ranks' kept and all slots sum to those of the prefill without a
    mesh."""
    out = run_ranks(COUNT_SCRIPT, 2, tmp_path)
    np.testing.assert_array_equal(out["total"], out["none"])
    assert 2 * out["rank"][1] == out["none"][1]
    assert out["none"][0] < out["none"][1]


def test_hybrid_prefill_and_train_step_on_mesh(tmp_path):
    """The smoke zamba2 (Mamba2 layers with their SSD on each rank's heads
    and batch, and the tied attention block) on a (2, 2) mesh: prefill
    logits and every cache leaf, and a train step, equal to mesh=None."""
    out = _run_steps(tmp_path, "zamba2-2.7b", (2, 2), 64, {
        "none": {}, "mesh": {}})
    _assert_same(out, "mesh", "none")


RESTORE_SCRIPT = """
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import shardings_for_cell
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train import TrainLoop, TrainLoopConfig
    cfg = get_smoke_config("stablelm-1.6b").replace(compute_dtype="float32")
    ckpt = os.path.join(OUT, "ckpt")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 32), generator=g).numpy()
    data = [{"tokens": toks, "labels": np.roll(toks, -1, 1)}] * 4
    m24 = make_mesh((2, 4), ("data", "model"))
    loop = TrainLoop(cfg, TrainLoopConfig(total_steps=2, ckpt_every=1,
                                          ckpt_dir=ckpt),
                     data, mesh=m24, rules=part.rules_for(m24, 4),
                     seed=0, device="cpu")
    loop.run()
    saved = whole({"params": loop.params, "opt": loop.opt_state})

    def shardings(mesh):
        cell = shardings_for_cell(cfg, ShapeConfig("t", 32, 4, "train"),
                                  mesh)
        return {"params": cell["params_sh"], "opt": cell["opt_sh"]}
    m42 = make_mesh((4, 2), ("data", "model"))
    loop42 = TrainLoop(cfg, TrainLoopConfig(total_steps=2, ckpt_every=1,
                                            ckpt_dir=ckpt),
                       data, mesh=m42, rules=part.rules_for(m42, 4),
                       seed=5, device="cpu")
    step = loop42.restore(shardings(m42))
    placed = [tuple(t.placements) for t in tree_leaves(loop42.params)]
    want = [sh.placements for sh in tree_leaves(shardings(m42)["params"])]
    assert placed == want
    got42 = whole({"params": loop42.params, "opt": loop42.opt_state})
    plain = TrainLoop(cfg, TrainLoopConfig(total_steps=2, ckpt_every=1,
                                           ckpt_dir=ckpt),
                      data, seed=7, device="cpu")
    plain.restore()
    assert not any(isinstance(t, part.DTensor)
                   for t in tree_leaves(plain.params))
    got_none = whole({"params": plain.params, "opt": plain.opt_state})
    save(step=np.int64(step),
         **{f"saved {i}": a for i, a in enumerate(saved)},
         **{f"m42 {i}": a for i, a in enumerate(got42)},
         **{f"none {i}": a for i, a in enumerate(got_none)})
"""


def test_restore_onto_another_mesh_is_bitwise(tmp_path):
    """Elastic restore: a TrainLoop on a (2, 4) mesh saves through the ring
    after step 1 (its DTensors' whole values, written by rank 0); a loop on
    a (4, 2) mesh restores it with ``restore(shardings)`` placed as
    ``shardings_for_cell`` says, and a loop without a mesh with
    ``restore()``: every parameter and optimizer leaf bit for bit."""
    out = run_ranks(RESTORE_SCRIPT, 8, tmp_path)
    assert int(out["step"]) == 1
    n = len([k for k in out if k.startswith("saved ")])
    assert n > 0
    for i in range(n):
        np.testing.assert_array_equal(out[f"m42 {i}"], out[f"saved {i}"])
        np.testing.assert_array_equal(out[f"none {i}"], out[f"saved {i}"])
