"""The dry run on the CPU (``repro_torch.launch.dryrun``): smoke cells
traced on fake tensors over fake process groups of 8 ranks, at (2, 4) and
(2, 2, 2), each in a process of its own; their FLOPs held against the
dots of the JAX package's compiled step, product for product; the
counters and the roofline terms; and the committed sweep artifacts, the
twin of ``tests/test_roofline.py``'s ``test_dryrun_artifacts_exist_and_fit``
at 80 GB a card."""

import collections
import glob
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import lm as jlm
from repro.optim import adamw_init as jax_adamw_init
from repro.roofline import hlo_cost
from repro_torch.launch.mesh import (GPUS_PER_NODE, HBM_BW, INTERNODE_BW,
                                     NVLINK_BW, PEAK_FLOPS_BF16,
                                     crosses_nodes)
from repro_torch.roofline import collective_bytes_moved, roofline_terms

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
TIMEOUT = 600
B, S = 8, 64                     # the smoke cells' batch and sequence
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CELLS = [(arch, kind, mesh) for arch, kind in (
    ("stablelm-1.6b", "train"), ("stablelm-1.6b", "prefill"),
    ("stablelm-1.6b", "decode")) for mesh in MESHES] + [
    ("zamba2-2.7b", "decode", "2x4"), ("mixtral-8x22b", "prefill", "2x2x2")]
# one device, against JAX's compiled step: (arch, kind), batch 4
JAX_CELLS = [("stablelm-1.6b", "prefill"), ("stablelm-1.6b", "train"),
             ("mixtral-8x22b", "prefill")]

CELL_SCRIPT = textwrap.dedent("""
    import json, sys, warnings
    warnings.filterwarnings("ignore")
    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.roofline import counters
    arch, kind, dims, axes, batch, out = json.loads(sys.argv[1])
    products = []
    count = counters.StepCounter._count

    def record(self, func, args, kwargs, res):
        before = self.flops
        count(self, func, args, kwargs, res)
        if self.flops > before and func.namespace == "aten":
            products.append(self.flops - before)
    counters.StepCounter._count = record
    r = dryrun.run_cell(arch, ShapeConfig(f"{kind}_smoke", 64, batch, kind),
                        False, out, device="cpu",
                        mesh_shape=(tuple(dims), tuple(axes)),
                        config=get_smoke_config(arch))
    r["products"] = products
    print(json.dumps(r))
""")


def _spawn(arch, kind, dims, axes, batch, out):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, "-c", CELL_SCRIPT,
         json.dumps([arch, kind, dims, axes, batch, str(out)])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Every smoke cell (8 fake ranks) and every one-device cell, each in
    a process of its own, all started together: key -> run_cell's
    result, with the aten products' FLOPs in trace order."""
    out = tmp_path_factory.mktemp("dryrun")
    procs = {}
    for arch, kind, mesh in CELLS:
        procs[(arch, kind, mesh)] = _spawn(arch, kind, *MESHES[mesh], B, out)
    for arch, kind in JAX_CELLS:
        procs[(arch, kind, "1x1")] = _spawn(arch, kind, (1, 1),
                                            ("data", "model"), 4, out)
    results = {}
    try:
        for key, p in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"{key}: {stderr[-4000:]}"
            results[key] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


@pytest.mark.parametrize("arch,kind,mesh", CELLS)
def test_dryrun_traces_smoke_cells(traced, arch, kind, mesh):
    """status ok, FLOPs and bytes, collectives by kind (the DTensor
    collectives on a mesh of 8; the CPU mesh replaces a Shard -> Shard
    all-to-all by an all-gather, so kinds are not the card's), a peak
    above the inputs held at the start, the kernel ops counted, and the
    roofline terms."""
    r = traced[(arch, kind, mesh)]
    assert r["status"] == "ok" and r["n_chips"] == 8 and r["mesh"] == mesh
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert r["collectives"] and all(
        v["count"] > 0 and v["bytes"] > 0 for v in r["collectives"].values())
    assert r["collective_moved_per_device"] > 0
    assert r["comm_debug_agrees"] and sum(r["comm_debug_counts"].values()) \
        == sum(v["count"] for v in r["collectives"].values())
    mem = r["memory"]
    assert mem["peak_est_bytes"] > mem["params_bytes"] + mem["inputs_bytes"]
    want_ops = {"train": {"flash_fwd_lse", "flash_bwd", "adamw_sumsq",
                          "adamw_norm", "adamw_update_"},
                "prefill": {"flash_fwd"},
                "decode": {"paged_attention_lse"}}[kind]
    if arch == "zamba2-2.7b":
        want_ops = want_ops | {"ssd_chunk"}
    if arch == "mixtral-8x22b":                # the MoE dispatch's slots
        want_ops = want_ops | {"moe_slots"}
    assert set(r["kernel_ops"]) == want_ops
    t = r["roofline"]
    assert t["t_bound_s"] == max(t["t_compute_s"], t["t_memory_s"],
                                 t["t_collective_s"]) > 0
    assert r["mesh_device"] == "cpu" and r["useful_flops_frac"] > 0


def test_dryrun_counts_the_adamw_ops_at_their_work():
    """A train step traced on plain fake tensors (one device, no mesh)
    counts the optimizer as the three AdamW ops, once each, at
    ``roofline.work``'s bytes: 4 B an fp32 gradient element for the sum
    of squares, its partials for the finish (on CPU tensors each leaf's
    fp32 sum), 28 B an element for the update. (The mesh cells above take
    the same ops on their local shards.)"""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.roofline import work
    from repro_torch.roofline.counters import StepCounter
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_smoke_config("stablelm-1.6b")
    with FakeTensorMode():
        params = tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype),
                          lm.abstract_params(cfg))
        toks = torch.zeros((2, S), dtype=torch.int32)
        counter = StepCounter()
        with counter:
            make_train_step(cfg)(params, adamw_init(params),
                                 {"tokens": toks, "labels": toks})
    n = sum(p.numel() for p in tree_leaves(params))
    ops = counter.kernel_ops()
    assert {"flash_fwd_lse", "flash_bwd"} < set(ops)
    assert ops["adamw_sumsq"] == {"calls": 1, "flops": 0,
                                  "bytes": work.adamw_sumsq_work(n)[0]}
    assert ops["adamw_norm"] == {
        "calls": 1, "flops": 0,
        "bytes": work.adamw_norm_work(len(tree_leaves(params)), 4)[0]}
    assert ops["adamw_update_"] == {"calls": 1, "flops": 0,
                                    "bytes": work.adamw_update_work(n)[0]}
    assert work.adamw_update_work(n)[0] == 28 * n


def _jax_dots(arch, kind):
    """Each dot of JAX's compiled step for the cell (batch 4, seq 64, one
    device) as (rank of its result, FLOPs) -> count, a while body's dots
    counted its trip count times (``hlo_cost``'s rule)."""
    cfg = jax_smoke(arch)
    p = jlm.abstract_params(cfg)
    toks = jax.ShapeDtypeStruct((4, S), jnp.int32)
    if kind == "prefill":
        comp = jax.jit(jax_prefill_step(cfg)).lower(
            p, {"tokens": toks}).compile()
    else:
        comp = jax.jit(jax_train_step(cfg)).lower(
            p, jax.eval_shape(jax_adamw_init, p),
            {"tokens": toks, "labels": toks}).compile()
    text = comp.as_text()
    comps, entry = hlo_cost.parse_module(text)
    dots = collections.Counter()

    def walk(name, mult):
        for ins in comps[name].instrs:
            if ins.op == "dot":
                rank = len(hlo_cost._shape_dims(ins.type_text))
                dots[(rank, int(hlo_cost._dot_flops(ins, comps[name])))] += \
                    mult
            elif ins.op == "while":
                trips = int(hlo_cost._TRIP_RE.search(ins.rest).group(1))
                walk(hlo_cost._BODY_RE.search(ins.rest).group(1),
                     mult * trips)
            elif ins.op in ("fusion", "call", "async-start", "custom-call"):
                m = hlo_cost._CALLS_RE.search(ins.rest)
                if m:
                    walk(m.group(1), mult)
    walk(entry, 1)
    total = sum(f * n for (_, f), n in dots.items())
    assert total == hlo_cost.analyze(text).dot_flops
    return cfg, dots


@pytest.mark.parametrize("arch,kind", JAX_CELLS)
def test_dryrun_flops_match_jax_product_for_product(traced, arch, kind):
    """The projection, MLP, head, router and expert products of the
    port's trace (aten mm / bmm, one device) are, product for product,
    the dots of JAX's compiled step that hlo_cost counts, but for the
    attention dots. Named differences: JAX computes attention in jnp
    (``repro/models/attention.py``), one (q_chunk x k_chunk) block at a
    time with its masked entries (here one 64 x 64 block a layer: Q·Kᵀ
    and P·V forward, and in training its custom VJP's five block products
    too), where the port calls its kernel ops, counted by
    ``roofline.work`` over the allowed pairs only."""
    r = traced[(arch, kind, "1x1")]
    cfg, dots = _jax_dots(arch, kind)
    attention = {k: n for k, n in dots.items() if k[0] == 4}
    products = collections.Counter({f: n for (rank, f), n in dots.items()
                                    if rank < 4})
    assert collections.Counter(r["products"]) == products
    qk = 2 * 4 * cfg.n_heads * S * S * cfg.hd
    per_layer = 2 if kind == "prefill" else 7
    assert attention == {(4, qk): per_layer * cfg.n_layers}
    pairs = S * (S + 1) // 2
    ops = r["kernel_ops"]
    fwd = "flash_fwd" if kind == "prefill" else "flash_fwd_lse"
    assert ops[fwd]["calls"] == cfg.n_layers
    assert ops[fwd]["flops"] == \
        cfg.n_layers * 2 * 4 * cfg.n_heads * 2 * cfg.hd * pairs
    if kind == "train":
        assert ops["flash_bwd"]["flops"] == \
            cfg.n_layers * 2 * 4 * cfg.n_heads * 5 * cfg.hd * pairs
    assert r["flops_per_device"] == sum(r["products"]) + sum(
        v["flops"] for v in ops.values())


def test_collective_formulas_and_h100_terms():
    """The ring formulas of ``repro/roofline/analysis.py`` and the
    roofline terms at the H100's data-sheet rates: NVLink inside a node of
    8, the network between nodes."""
    moved, by = collective_bytes_moved(
        [{"kind": "all-reduce", "bytes": 100, "group": 4},
         {"kind": "all-gather", "bytes": 100, "group": 4,
          "internode": True},
         {"kind": "reduce-scatter", "bytes": 25, "group": 4}])
    assert moved == pytest.approx(150 + 75 + 75)
    assert by["all-gather"]["moved_internode"] == pytest.approx(75)
    t = roofline_terms(hlo_flops=PEAK_FLOPS_BF16, hlo_bytes=0, coll_moved=0,
                       n_chips=1)
    assert t["bottleneck"] == "compute" and t["t_bound_s"] == 1.0
    t = roofline_terms(hlo_flops=0, hlo_bytes=HBM_BW, coll_moved=0,
                       n_chips=1)
    assert t["bottleneck"] == "memory"
    t = roofline_terms(hlo_flops=0, hlo_bytes=0, coll_moved=NVLINK_BW +
                       INTERNODE_BW, coll_moved_internode=INTERNODE_BW,
                       n_chips=1)
    assert t["bottleneck"] == "collective" and t["t_collective_s"] == 2.0
    assert GPUS_PER_NODE == 8 and not crosses_nodes(range(8)) and \
        crosses_nodes([7, 8]) and crosses_nodes(range(0, 256, 16))


def test_counter_counts_local_shards_and_live_storages():
    """On a fake group of 4 (2 x 2), a matmul of DTensors is counted at its
    local shapes (not the global ones DTensor's sharding propagation
    runs), its collectives as CommDebugMode sees them, views are free, and
    a storage counts as live until its last tensor is freed."""
    code = textwrap.dedent("""
        import gc, json, warnings
        warnings.filterwarnings("ignore")
        import torch, torch.distributed as dist
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.distributed.tensor.debug import CommDebugMode
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.roofline.counters import StepCounter
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=4)
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        out = {}
        with FakeTensorMode():
            a = DTensor.from_local(torch.empty(8, 32), mesh,
                                   [Shard(0), Replicate()], run_check=False)
            w = DTensor.from_local(torch.empty(32, 8), mesh,
                                   [Replicate(), Shard(1)], run_check=False)
            c = StepCounter()
            held = c.hold([a, w])
            with CommDebugMode() as comm, c:
                y = a @ w                          # (16, 16) global
                y = y.redistribute(mesh, [Replicate(), Replicate()])
                v = y.view(-1)
                del y
                out["views"] = c.by_op.get("aten.view", [0, 0, 0])[2]
                t = torch.empty(1000)
                live = c.live
                del t
                gc.collect()
                out["freed"] = live - c.live
            out.update(flops=c.flops, records=len(c.records),
                       comm=sum(comm.get_comm_counts().values()),
                       held=held, peak=c.peak,
                       kinds=sorted({r["kind"] for r in c.records}))
            del v
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["flops"] == 2 * 8 * 32 * 8            # the local product
    assert out["records"] == out["comm"] > 0
    assert out["kinds"] == ["all-gather"]
    assert out["views"] == 0 and out["freed"] == 4000
    assert out["held"] == (8 * 32 + 32 * 8) * 4
    assert out["peak"] >= out["held"] + 16 * 16 * 4


# cells traced over 80 GB a card, with the reason (the artifact's
# memory.peak_holders: live bytes at the peak by allocating operator)
OVER_80GB = {
    # 2 x 16 x 16 only (16 x 16: 69.9 GB): 86.3 GB at the peak, 46.3 GB of
    # it stacked layer gradients (the backward of the per-layer unbind,
    # lm._layers, stacks each layer's weight gradient as DTensor hands it
    # back, not yet reduced over the FSDP axes) and 35.2 GB of casts
    ("mixtral-8x22b", "train_4k"): "stacked unsharded layer gradients",
}


def test_dryrun_artifacts_exist_and_fit():
    """The sweep (``python -m repro_torch.launch.dryrun --all --device
    cuda`` on the card machine) wrote every (arch x shape x mesh) cell, each
    ``ok`` or skipped as JAX skips it, and every cell's traced peak fits
    a card's 80 GB, but those OVER_80GB names with their reason."""
    from repro_torch.launch.mesh import HBM_BYTES
    files = glob.glob(str(ROOT / "experiments" / "dryrun_torch" / "*.json"))
    if not files:
        pytest.skip("dry-run sweep artifacts not present")
    assert len(files) == 80
    ok = skipped = 0
    over = []
    for fn in files:
        with open(fn) as f:
            r = json.load(f)
        if "skipped" in r.get("status", ""):
            skipped += 1
            continue
        assert r["status"] == "ok", fn
        assert r["mesh_device"] == "cuda", fn
        ok += 1
        peak = r["memory"]["peak_est_bytes"]
        if peak > HBM_BYTES and (r["arch"], r["shape"]) not in OVER_80GB:
            over.append((os.path.basename(fn), peak / 1e9))
    assert ok + skipped == len(files)
    assert not over, f"cells over 80 GB a card: {over}"
