"""CPU tests of the benchmark harness (``bench/``): traffic, the
yardstick's arithmetic, the reference against the program's CPU route,
the result line, the imports, the data-driven layout, and that the check
fails the control and the faults it must catch."""

import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import tiny
from bench import checks, harness, tracing, traffic, work
from bench.reference import model as ref

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(scope="module")
def tb(tmp_path_factory):
    root = tmp_path_factory.mktemp("tb")
    return tiny.write(root), root / "tinybench"


@pytest.fixture(scope="module")
def tb32(tmp_path_factory):
    root = tmp_path_factory.mktemp("tb32")
    return tiny.write(root, compute="float32"), root / "tinybench"


def run(tb, cell, seed=7, trace=False, **kw):
    spec, data = tb
    return harness.run_cell(spec, cell, seed, 0.2, trace, device="cpu",
                            data_root=data, **kw)


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["decode-b16", "prefill-long",
                                  "decode-b32"])
def test_serve_traffic_is_deterministic_by_seed(name):
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    n = len(traffic.lengths(t))
    a = [traffic.unit(t, 2**31 + 5, i, 1000) for i in range(2 * n)]
    b = [traffic.unit(t, 2**31 + 5, i, 1000) for i in range(2 * n)]
    c = [traffic.unit(t, 11, i, 1000) for i in range(2 * n)]
    for x, y in zip(a, b):
        assert x["S0"] == y["S0"]
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
    assert any(not np.array_equal(x["tokens"], z["tokens"])
               for x, z in zip(a, c))
    # every seed sends the same lengths in the same order, pass after pass
    for us in (a, c):
        assert [u["S0"] for u in us] == 2 * traffic.lengths(t)
    assert all(u["tokens"].shape == (t["batch"], u["S0"]) for u in a)


def test_prefill_lengths_are_the_issue_mix():
    t = json.loads((BENCH / "traffic" / "prefill-long.json").read_text())
    ls = traffic.lengths(t)
    assert len(ls) == 64 and 2048 <= min(ls) and max(ls) <= 16384
    assert sum(1 for x in ls if x % 16) >= 56


def test_train_corpus_is_deterministic_by_seed():
    t = dict(json.loads((BENCH / "traffic" / "train-4k.json").read_text()),
             corpus_tokens=1000)
    np.testing.assert_array_equal(traffic.corpus(t, 3, 50),
                                  traffic.corpus(t, 3, 50))
    assert not np.array_equal(traffic.corpus(t, 3, 50),
                              traffic.corpus(t, 4, 50))


# ---------------------------------------------------------------------------
# the yardstick
# ---------------------------------------------------------------------------

SMALL = {"family": "moe", "n_layers": 1, "d_model": 4, "n_heads": 2,
         "n_kv_heads": 1, "head_dim": 2, "d_ff": 8, "vocab_size": 10,
         "moe": {"n_experts": 4, "n_shared": 0, "top_k": 2,
                 "d_ff_expert": 3, "first_k_dense": 0}}


@pytest.mark.parametrize("fn,args,want", [
    # pairs 10; q,o (1*4*2*16*2) + k,v (1*4*1*16*2); 2*2*16*10
    (work.flash_fwd_work, (1, 4, 4, 2, 1, 8, 8, 2), (384, 640)),
    # q,o,dq,do + k,v,dk,dv + lse; 2*2*(3*8+2*8)*10
    (work.flash_bwd_work, (1, 4, 4, 2, 1, 8, 8, 2), (800, 1600)),
    # k,v 2*2*5*2*8*2 + q,o 2*2*4*8*2 + table 8 + lengths 8; 4*2*4*8*5
    (work.paged_work, (2, 4, 2, 8, 5, 1, 2), (912, 1280)),
])
def test_kernel_work_matches_hand_counts(fn, args, want):
    assert fn(*args) == want


def test_model_flops_match_hand_counts():
    # a token multiplies attention 2*4*2*2 + 2*4*1*2 = 48 and router 16
    # plus two experts 2*3*4*3 = 72: 136 parameters
    assert work.token_matmul_params(ref, SMALL) == 136
    # 3 tokens: 2*3*136 + attention 2*2*(2+2)*6 pairs + head 2*4*10
    assert work.prefill_flops(ref, SMALL, 1, 3) == 816 + 96 + 80
    # a token at position 2 attends 3 keys
    assert work.decode_flops(ref, SMALL, 1, 2) == 272 + 48 + 80
    # training: three forwards, the head at all 3 positions
    assert work.train_step_flops(ref, SMALL, 1, 3) == 3 * (816 + 96 + 240)
    assert work.generate_flops(ref, SMALL, 1, 3, 2) == \
        work.prefill_flops(ref, SMALL, 1, 3) + \
        work.decode_flops(ref, SMALL, 1, 3)
    # as a metric's reader sees it, bound to the model module
    w = work.bind(ref)
    assert w.prefill_flops(SMALL, 1, 3) == 816 + 96 + 80
    assert w.flash_fwd_work is work.flash_fwd_work
    assert w.PEAK_FLOPS_BF16 == work.PEAK_FLOPS_BF16


def test_bound_takes_the_larger_term():
    assert work.bound_s(work.HBM_BW, 0) == pytest.approx(1.0)
    assert work.bound_s(0, work.PEAK_FLOPS_BF16) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# the reference against the program's CPU route
# ---------------------------------------------------------------------------

def test_reference_routing_matches_the_program():
    """Routing, capacity and the slots kept, where experts overflow."""
    from repro_torch.configs.base import MoEConfig, ModelConfig
    from repro_torch.models import moe as moe_mod
    e = {"n_experts": 16, "top_k": 2, "capacity_factor": 1.25}
    cfg = ModelConfig(arch_id="t", family="moe", n_layers=1, d_model=8,
                      n_heads=2, n_kv_heads=2, d_ff=8, vocab_size=16,
                      moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=4))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 1, 200, 8, generator=g)
    router = torch.randn(8, 16, generator=g)
    router[:, 0] += 2.0                 # crowd expert 0 past its capacity
    _, slot, keep, _, _, _ = moe_mod._dispatch(cfg, router, x, torch.float32)
    zero = torch.zeros(200, dtype=torch.long)
    _, ids, _, kept = ref.route(e, router, x[0, 0], zero,
                                torch.arange(200))
    assert (~kept).any()
    torch.testing.assert_close(slot[0, 0] // moe_mod.capacity(cfg, 200),
                               ids.reshape(-1))
    torch.testing.assert_close(keep[0, 0], kept.reshape(-1))


@pytest.mark.parametrize("cell", ["mla-serve", "gqa-serve", "mla-prefill"])
def test_reference_agrees_with_the_port_serving(tb32, cell):
    # the program in fp32 keeps its decode caches in bf16: a served
    # token may lie a few hundredths below the best
    for seed in (1, 2):
        out = run(tb32, cell, seed)
        assert out["checks"]["logit_gap_max"]["value"] < 0.05


def test_reference_agrees_with_the_port_training(tb32):
    for seed in (1, 2):
        p = {k: v["value"] for k, v in run(tb32, "mla-train",
                                           seed)["checks"].items()}
        assert p["loss_gap"] < 1e-5 and p["grad_gap"] < 1e-4 \
            and p["change_gap"] < 1e-3


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell,trace", [("mla-serve", False),
                                        ("mla-serve", True),
                                        ("mla-prefill", False),
                                        ("mla-train", True)])
def test_result_line_schema(tb, cell, trace):
    out = json.loads(json.dumps(run(tb, cell, 3, trace)))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert isinstance(out["correct"], bool) and out["attempted"] >= 1
    assert out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in out["metrics"]


@pytest.mark.parametrize("cell,per", [("mla-serve", 4), ("mla-prefill", 5)])
def test_a_window_holds_whole_passes_of_the_lengths(tb, cell, per):
    out = run(tb, cell, 5)
    assert out["attempted"] >= per and out["attempted"] % per == 0


def test_launches_count_the_host_calls_and_a_graph_once():
    # one generate: prefill launches before the arg-max, then a decode
    # phase of two kernel launches and one graph that replays five kernels
    cpu = [(0, 1000, tracing.UNIT, 0, 1),
           (10, 11, "cudaLaunchKernel", 1, 1),
           (20, 21, "cuLaunchKernel", 2, 1),
           (100, 110, tracing.PICK, 0, 1),
           (200, 201, "cudaLaunchKernel", 5, 1),
           (300, 301, "cudaLaunchKernelExC", 6, 1),
           (400, 401, "cudaGraphLaunch", 7, 1),
           (500, 501, "cudaMemcpyAsync", 8, 1),
           (2000, 2001, "cudaLaunchKernel", 9, 1)]
    dev = [(12, 15, "prefill_a", 1), (22, 25, "prefill_b", 2),
           (202, 210, "k", 5), (302, 310, "k_cluster", 6),
           (502, 505, "Memcpy DtoH", 8), (2002, 2005, "after", 9)] + \
        [(402 + 10 * i, 409 + 10 * i, f"graph_{i}", 7) for i in range(5)]
    d = tracing.reduce(cpu, dev, 1e-6)
    assert d.decode_launches() == 3
    assert d.busy_s > 0
    assert tracing.reduce(cpu[:4], dev[:2], 1e-6).decode_launches() is None


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines "
                    "without one")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"),
                        "--workload", SPEC["workloads"][0]["name"],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------

def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_a_run_loads_no_jax_module(tb):
    spec, data = tb
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from bench import harness\n"
        "harness.run_cell(%r, 'mla-serve', 1, 0.1, True, device='cpu', "
        "data_root=%r)\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in %r))"
        % (str(ROOT), str(ROOT / "src"), str(spec), str(data), FORBIDDEN))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, USE_FLAX="0"))
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


# ---------------------------------------------------------------------------
# driven by data
# ---------------------------------------------------------------------------

def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    before = tiny.harness_digest()
    spec_path = tiny.write(tmp_path)
    data = tmp_path / "tinybench"
    (data / "configs" / "tiny-new.json").write_text(json.dumps(
        {"model": dict(tiny.GQA_MOE, n_layers=1)}))
    (data / "traffic" / "serve-new.json").write_text(json.dumps(
        dict(tiny.SERVE, batch=2, n_new=3, lengths=[12, 17])))
    (data / "limits" / "new-cell.json").write_text(json.dumps(
        tiny.SERVE_LIMITS))
    (data / "metrics" / "served_tokens.py").write_text(
        "def read(ctx):\n"
        "    return float(sum(u['B'] * u['n_new'] for u in ctx.units))\n")
    spec = json.loads(spec_path.read_text())
    spec["configs"].append({"name": "tiny-new", "source": "t", "reduced": [],
                            "why": "t",
                            "file": "tinybench/configs/tiny-new.json"})
    spec["workloads"].append({"name": "new-cell", "config": "tiny-new",
                              "traffic": "serve-new", "chips": 1,
                              "why": "t"})
    for e in spec["end_to_end"]:
        if e["name"] == "decode_tokens_per_s":
            e["workloads"].append("new-cell")
    spec["per_layer"].append({"name": "served_tokens", "unit": "tokens",
                              "better": "higher", "source": "host_clock",
                              "layer": "t", "moves": "decode_tokens_per_s",
                              "workloads": ["new-cell"]})
    spec_path.write_text(json.dumps(spec))
    out = harness.run_cell(spec_path, "new-cell", 5, 0.2, True,
                           device="cpu", data_root=data)
    assert out["correct"]
    assert out["metrics"]["served_tokens"]["value"] == 2 * 3 * \
        out["attempted"]
    out = harness.run_cell(spec_path, "new-cell", 5, 0.2, False,
                           device="cpu", data_root=data)
    assert set(out["metrics"]) == {"decode_tokens_per_s", "setup_s"}
    assert tiny.harness_digest() == before


def test_every_cell_has_its_files():
    names = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for n in names:
        assert (BENCH / "metrics" / f"{n}.py").exists(), n
    for w in SPEC["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        harness.model_of(cfg)           # agrees with its published keys
    e2e = {e["name"]: e for e in SPEC["end_to_end"]}
    for p in SPEC["per_layer"]:
        for w in p["workloads"]:
            assert w in e2e[p["moves"]].get("workloads", [w])
    for n in names | {w["name"] for w in SPEC["workloads"]}:
        assert re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", n)


# ---------------------------------------------------------------------------
# the check fails the control and the faults
# ---------------------------------------------------------------------------

def _fails(numbers, limits):
    return not checks.judge(numbers, limits)[0]


@pytest.mark.parametrize("cell", ["mla-serve", "gqa-serve", "mla-train"])
def test_the_control_is_not_correct(tb32, cell):
    limits = tiny.TRAIN_LIMITS if cell == "mla-train" else tiny.SERVE_LIMITS
    for seed in (1, 2, 3):
        r = run(tb32, cell, seed, calibrate=True)["readings"]
        assert not _fails(r["program"], limits)
        assert _fails(r["control"], limits)


def _alter_a_token(loop):
    step = loop.step

    def bad(params, cache, tok, pos):
        nxt, cache = step(params, cache, tok, pos)
        return nxt.clone().index_fill_(0, torch.tensor([0]), 3), cache
    loop.step = bad


def _half_batch(monkeypatch):
    from repro_torch.launch import steps
    real = steps.loss_and_grads

    def half(cfg, params, batch, mesh=None, rules=None):
        n = batch["tokens"].shape[0] // 2
        return real(cfg, params, {k: v[:n] for k, v in batch.items()},
                    mesh, rules)
    monkeypatch.setattr(steps, "loss_and_grads", half)


def _frozen(monkeypatch):
    from repro_torch.launch import steps
    real = steps.adamw_update

    def frozen(grads, state, params, *, lr):
        kept = [p.clone() for p in steps.tree_flatten(params)[0]]
        params, state, g = real(grads, state, params, lr=lr)
        for p, k in zip(steps.tree_flatten(params)[0], kept):
            p.copy_(k)
        return params, state, g
    monkeypatch.setattr(steps, "adamw_update", frozen)


@pytest.mark.parametrize("fault", ["token", "half_batch", "frozen"])
def test_a_broken_timed_path_is_not_correct(tb32, monkeypatch, fault):
    if fault == "token":
        for cell in ("mla-serve", "gqa-serve"):
            sound = run(tb32, cell, 4)["checks"]["logit_gap_max"]["value"]
            bad = run(tb32, cell, 4, fault=_alter_a_token)
            assert not bad["correct"]
            assert bad["checks"]["logit_gap_max"]["value"] > sound
        return
    assert run(tb32, "mla-train", 4)["correct"]
    {"half_batch": _half_batch, "frozen": _frozen}[fault](monkeypatch)
    assert not run(tb32, "mla-train", 4)["correct"]
