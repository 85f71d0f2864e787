"""One run of one cell: set-up, the measured window, the traced window,
the check against the reference, and the result line.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
names a configuration (whose ``file`` is given there) and a traffic mix
(``traffic/<name>.json``); the configuration's file may name its model
module (``"reference"``: ``reference/<name>.py``, ``bench.reference``);
its limits are ``limits/<cell>.json``; each metric is computed by
``metrics/<metric>.py``'s ``read(ctx)``. The data folders are those
beside ``BENCHMARK.json``'s ``paths``; a test may point the harness at
copies of them (``data_root``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from bench import checks, reference, traffic, tracing
from bench import weights as W
from bench import work

HERE = pathlib.Path(__file__).resolve().parent

# keys of a configuration's published config.json, and where the model
# description (its "model" object) holds the same number
HF_KEYS = {
    "hidden_size": ("d_model",), "num_hidden_layers": ("n_layers",),
    "num_attention_heads": ("n_heads",),
    "num_key_value_heads": ("n_kv_heads",), "vocab_size": ("vocab_size",),
    "intermediate_size": ("d_ff",), "rope_theta": ("rope_theta",),
    "rms_norm_eps": ("norm_eps",),
    "kv_lora_rank": ("mla", "kv_lora_rank"),
    "q_lora_rank": ("mla", "q_lora_rank"),
    "qk_nope_head_dim": ("mla", "qk_nope_head_dim"),
    "qk_rope_head_dim": ("mla", "qk_rope_head_dim"),
    "v_head_dim": ("mla", "v_head_dim"),
    "n_routed_experts": ("moe", "n_experts"),
    "num_local_experts": ("moe", "n_experts"),
    "num_experts_per_tok": ("moe", "top_k"),
    "n_shared_experts": ("moe", "n_shared"),
    "moe_intermediate_size": ("moe", "d_ff_expert"),
    "first_k_dense_replace": ("moe", "first_k_dense"),
    "scoring_func": ("moe", "scoring_func"),
    "topk_method": ("moe", "topk_method"),
    "n_group": ("moe", "n_group"),
    "topk_group": ("moe", "topk_group"),
    "routed_scaling_factor": ("moe", "routed_scaling_factor"),
    "norm_topk_prob": ("moe", "norm_topk_prob"),
    "rope_scaling": ("rope_scaling",),
}
# fields of the program's ModelConfig that the harness sets itself, and
# the program's switches of how it runs (kernels, tiling, sharding,
# precision of its parts): refused in a model, which states the model only
HARNESS_SET = ("arch_id", "param_dtype", "remat", "microbatches")
PROGRAM_SET = ("scan_layers", "attn_q_chunk", "attn_schedule", "use_pallas",
               "bf16_stacked_params", "sp_norm", "ssm_chunk", "ssm_bf16",
               "moe_impl", "moe_fsdp_out", "grad_compression")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def model_of(config: dict) -> dict:
    """The configuration file's model description, refused where it
    disagrees with the published numbers beside it."""
    m = config["model"]
    for key, path in HF_KEYS.items():
        if key not in config or config[key] is None:
            continue
        node = m
        for k in path:
            node = node.get(k) if isinstance(node, dict) else None
        if node is not None and node != config[key]:
            raise ValueError(f"model {'.'.join(path)} = {node} but the "
                             f"configuration's {key} = {config[key]}")
    sw = config.get("sliding_window", 0) or 0
    if sw != m.get("swa_window", 0):
        raise ValueError("model swa_window differs from sliding_window")
    return m


def _build(cls, kw: dict, where: str):
    """``cls(**kw)``, a key that is not a field refused by name."""
    try:
        return cls(**kw)
    except TypeError as e:
        raise ValueError(f"{where}: {e}") from None


def port_config(m: dict, name: str, train: bool):
    """The program's configuration object for the model description: each
    key of ``m``, ``m["moe"]`` and ``m["mla"]`` is the program's field of
    that name; a key it lacks, or one the harness or the program sets, is
    refused."""
    from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig
    from repro_torch.models import moe as moe_mod
    ours = sorted(set(m) & set(HARNESS_SET + PROGRAM_SET))
    if ours:
        raise ValueError(f"model {ours}: set by the harness or the program, "
                         f"not the model")
    kw, split = dict(m), 1
    if kw.get("moe"):
        moe = dict(kw["moe"])
        # the harness's own key: how the program splits each expert
        split = moe.pop("expert_split", 1)
        kw["moe"] = _build(MoEConfig, moe, "model moe")
    if kw.get("mla"):
        kw["mla"] = _build(MLAConfig, kw["mla"], "model mla")
    if "rope_theta" in kw:
        kw["rope_theta"] = float(kw["rope_theta"])
    # an ungated GELU MLP (granite-34b) states mlp_kind "gelu"
    kw.setdefault("mlp_kind", "swiglu")
    cfg = _build(ModelConfig, dict(kw, arch_id=name, param_dtype="float32",
                                   remat=train, microbatches=1), "model")
    if cfg.moe is not None and split != moe_mod.expert_split(cfg):
        raise ValueError(f"model moe.expert_split = {split} but the program "
                         f"splits each expert in {moe_mod.expert_split(cfg)}")
    return cfg


def check_layout(tree: dict, abstract: dict, path=()):
    """Refuse a tree whose leaves are not the program's (names, shapes)."""
    if set(tree) != set(abstract):
        raise ValueError(f"tree {path}: {sorted(tree)} vs the program's "
                         f"{sorted(abstract)}")
    for k, v in tree.items():
        if isinstance(v, dict):
            check_layout(v, abstract[k], path + (k,))
        elif tuple(v.shape) != tuple(abstract[k].shape):
            raise ValueError(f"leaf {path + (k,)}: {tuple(v.shape)} vs the "
                             f"program's {tuple(abstract[k].shape)}")


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Cell:
    """A workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, spec_path, workload: str, data_root=None):
        spec_path = pathlib.Path(spec_path)
        self.spec = json.loads(spec_path.read_text())
        self.root = pathlib.Path(data_root) if data_root else HERE
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r}; the benchmark has "
                           f"{sorted(cells)}")
        self.w = cells[workload]
        cfgs = {c["name"]: c for c in self.spec["configs"]}
        self.config_entry = cfgs[self.w["config"]]
        self.config = json.loads(
            (spec_path.parent / self.config_entry["file"]).read_text())
        self.m = model_of(self.config)
        self.ref = reference.load(self.root, self.config.get("reference"))
        self.leaves = W.spec(self.m, self.ref)
        self.work = work.bind(self.ref)
        self.traffic = json.loads(
            (self.root / "traffic" / f"{self.w['traffic']}.json").read_text())
        self.limits = json.loads(
            (self.root / "limits" / f"{workload}.json").read_text())

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics this cell reports: end to end with ``trace`` 0, per
        layer with 1 (those that list the cell, or, without a list, that
        move an end-to-end metric the cell reports)."""
        name = self.w["name"]
        e2e = [e for e in self.spec["end_to_end"]
               if name in e.get("workloads", [name])]
        if not trace:
            return e2e
        mine = {e["name"] for e in e2e}
        return [p for p in self.spec["per_layer"]
                if name in p.get("workloads", [name] if p["moves"] in mine
                                 else [])]


def reader(root: pathlib.Path, name: str):
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _peak_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = "nvidia-smi unavailable"
    return (f"shares against the data sheet's {work.PEAK_FLOPS_BF16 / 1e12:g} "
            f"TFLOP/s bf16 and {work.HBM_BW / 1e12:g} TB/s; card: {out}")


# ---------------------------------------------------------------------------
# serving: one closed-loop client of ServeLoop.generate
# ---------------------------------------------------------------------------

def _serve(cell, seed, seconds, trace, dev, t_start, fault, calibrate):
    from repro_torch.models import lm
    from repro_torch.serve import ServeLoop
    m, t = cell.m, cell.traffic
    pc = port_config(m, cell.w["config"], train=False)
    tree = W.make_tree(cell.leaves, seed, dev, pc.compute_dt())
    check_layout(tree, lm.abstract_params(pc))
    ls = traffic.lengths(t)
    loop = ServeLoop(pc, tree, max_len=max(ls) + t["n_new"], device=dev)
    del tree
    if fault is not None:
        fault(loop)
    V = m["vocab_size"]
    warm = np.random.default_rng([seed, 3]).integers(
        0, V, (t["batch"], max(ls)), dtype=np.int32)
    loop.generate(warm, t["n_new"]).cpu()
    setup_s = time.time() - t_start

    per = traffic.pass_units(t)

    def more(units, t0, n_max):
        if n_max is not None:
            return len(units) < n_max and time.perf_counter() - t0 < seconds
        return time.perf_counter() - t0 < seconds or len(units) % per

    def window(n_max):
        """Units sent back to back until ``seconds`` have passed and the
        last pass of the traffic's lengths is whole (or ``n_max`` are
        done, within ``seconds``); the host time of the window."""
        units = []
        t0 = time.perf_counter()
        while more(units, t0, n_max):
            u = traffic.unit(t, seed, len(units), V)
            with tracing.unit_range():
                ts = time.perf_counter()
                served = loop.generate(u["tokens"], u["n_new"]).cpu()
                te = time.perf_counter()
            units.append({"index": u["index"], "S0": u["S0"],
                          "B": t["batch"], "n_new": u["n_new"],
                          "wall_s": te - ts, "served": served.numpy()})
        return units, time.perf_counter() - t0

    units, window_s = window(t.get("trace_units") if trace else None)
    digest = None
    if trace:
        # the same units again under the profiler; the walls above, with
        # no profiler, are what the shares of the peak divide by
        with tracing.profiling(True) as prof:
            _, traced_s = window(len(units))
        digest = tracing.digest(prof, traced_s)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    del loop
    free()
    pick = checks.sample_units(units, t["check_units"], seed)
    for u in pick:
        u["tokens"] = traffic.unit(t, seed, u["index"], V)["tokens"]
    read = checks.serve_readings(cell.ref, cell.leaves, m, seed, pick,
                                 dev, pc.compute_dt(), control=calibrate)
    log(f"check: {read['program']['tokens']} served tokens of {len(pick)} "
        f"of {len(units)} generates against the reference")
    return SimpleNamespace(kind="serve", units=units, setup_s=setup_s,
                           window_s=window_s, peak=peak, trace=digest,
                           numbers=read["program"], readings=read)


# ---------------------------------------------------------------------------
# training: TrainLoop.run fed by RingLoader, called in chunks of steps
# ---------------------------------------------------------------------------

class Feed:
    """The loader as the loop iterates it: one stream across the loop's
    calls, the first ``keep`` batches kept for the reference."""

    def __init__(self, loader, keep: int):
        self.it = iter(loader)
        self.keep = keep
        self.kept: List[dict] = []

    def __iter__(self):
        return self

    def __next__(self):
        b = next(self.it)
        if len(self.kept) < self.keep:
            self.kept.append({k: v.copy() for k, v in b.items()})
        return b


def _leaf_norms(leaves, tree, scale=1.0):
    return {leaf.name: float(W.get(tree, leaf.path).double().norm()) * scale
            for leaf in leaves}


def _train(cell, seed, seconds, trace, dev, t_start, fault, calibrate):
    from repro_torch.data.pipeline import RingLoader, TokenStore
    from repro_torch.models import lm
    from repro_torch.train.loop import TrainLoop, TrainLoopConfig
    m, t = cell.m, cell.traffic
    o = t["optimizer"]
    pc = port_config(m, cell.w["config"], train=True)
    tmp = tempfile.mkdtemp(prefix="bench-train-")
    try:
        path = os.path.join(tmp, "corpus.bin")
        traffic.corpus(t, seed, m["vocab_size"]).tofile(path)
        feed = Feed(RingLoader(TokenStore(path), batch=t["batch"],
                               seq=t["seq"], prefetch=4, seed=seed),
                    keep=t["reference_steps"])
        tree = W.make_tree(cell.leaves, seed, dev, torch.float32)
        check_layout(tree, lm.abstract_params(pc))
        # the window never reaches a checkpoint: one of this model would
        # be tens of GB, beyond what a run may write
        loop = TrainLoop(pc, TrainLoopConfig(
            total_steps=o["total"], ckpt_every=1 << 62,
            ckpt_dir=os.path.join(tmp, "ckpt"), log_every=1 << 62,
            peak_lr=o["peak_lr"]), feed, params=tree, device=dev)
        del tree
        if fault is not None:
            fault(loop)
        state = {"step": 0}

        def chunk(n):
            loop.start_step = state["step"]
            loop.lc.total_steps = state["step"] + n
            last = loop.run()
            state["step"] += n
            if dev.type == "cuda":
                torch.cuda.synchronize()
            return last

        prog = {"losses": []}
        for i in range(t["reference_steps"]):
            prog["losses"].append(chunk(1)["loss"])
            if i == 0:
                prog["grad"] = _leaf_norms(cell.leaves, loop.opt_state.m,
                                           1.0 / (1 - o["b1"]))
        with torch.no_grad():
            sq: Dict[str, float] = {}
            for leaf in cell.leaves:
                p = W.get(loop.params, leaf.path)
                for i in (range(leaf.layers) if leaf.layers is not None
                          else [None]):
                    d = (p[i] if i is not None else p) - \
                        W.draw(seed, leaf, i, dev)
                    sq[leaf.name] = sq.get(leaf.name, 0.0) + \
                        float(d.double().square().sum())
            prog["change"] = {k: math.sqrt(v) for k, v in sq.items()}
        setup_s = time.time() - t_start

        n = t["chunk_steps"]

        def window(n_max):
            units = []
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds and \
                    (n_max is None or len(units) < n_max):
                with tracing.unit_range():
                    ts = time.perf_counter()
                    last = chunk(n)
                    te = time.perf_counter()
                units.append({"steps": n, "B": t["batch"], "S": t["seq"],
                              "wall_s": te - ts, "loss": last["loss"]})
            return units, time.perf_counter() - t0

        units, window_s = window(t.get("trace_units") if trace else None)
        digest, losses = None, [u["loss"] for u in units]
        if trace:
            # the same chunks again under the profiler; the walls above
            # are what the share of the peak divides by
            with tracing.profiling(True) as prof:
                more, traced_s = window(len(units))
            digest = tracing.digest(prof, traced_s)
            losses += [u["loss"] for u in more]
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        finite = all(math.isfinite(x) for x in losses)
        del loop
        free()
        read = checks.train_readings(
            cell.ref, cell.leaves, m, o, seed, feed.kept, prog, dev,
            control=calibrate, faults=("half_batch",) if calibrate else ())
        numbers = dict(read["program"])
        if not finite:
            numbers["loss_gap"] = float("nan")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return SimpleNamespace(kind="train", units=units, setup_s=setup_s,
                           window_s=window_s, peak=peak, trace=digest,
                           numbers=numbers, readings=read)


def run_cell(spec_path, workload: str, seed: int, seconds: float,
             trace: bool, *, device="cuda", data_root=None,
             t_start: Optional[float] = None, fault=None,
             calibrate: bool = False) -> dict:
    """One run of ``workload``; returns the result object the command
    prints. ``fault`` (tests only) is called with the program's loop
    before the window, to break the timed path. With ``calibrate`` the
    check also reads the control (the reference in fp8 in the program's
    place) and, in training, the reference with half of each batch left
    out, and the result carries every reading under "readings"."""
    t_start = time.time() if t_start is None else t_start
    cell = Cell(spec_path, workload, data_root)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    run = {"serve": _serve, "train": _train}[cell.traffic["kind"]]
    r = run(cell, int(seed), float(seconds), bool(trace), dev, t_start,
            fault, calibrate)
    correct, shown = checks.judge(r.numbers, cell.limits)
    ctx = SimpleNamespace(cell=cell.w, m=cell.m, traffic=cell.traffic,
                          kind=r.kind, units=r.units, setup_s=r.setup_s,
                          window_s=r.window_s, trace=r.trace,
                          work=cell.work)
    metrics = {}
    for spec in cell.metrics(trace):
        v = reader(cell.root, spec["name"])(ctx)
        if v is not None:
            metrics[spec["name"]] = {"value": v, "unit": spec["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(r.peak)}
    if trace:
        device_info["busy_s"] = r.trace.busy_s
        device_info["window_s"] = r.trace.window_s
    out = {"correct": bool(correct), "attempted": len(r.units), "failed": 0,
           "metrics": metrics, "device": device_info}
    if trace:
        out["breakdown"] = r.trace.breakdown
    if r.kind == "serve":
        walls = sorted(1e3 * u["wall_s"] for u in r.units)
        log(f"requests {len(walls)}: wall ms median "
            f"{float(np.median(walls)):.3f}, p95 "
            f"{float(np.percentile(walls, 95)):.3f}, max {walls[-1]:.3f}")
    log(f"setup_s {r.setup_s:.3f}, window_s {r.window_s:.3f}, "
        f"max_memory_allocated {r.peak} bytes")
    if trace:
        log(_peak_line())
    for k, v in r.numbers.items():
        log(f"reading {k} {v}")
    for k, v in shown.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    if calibrate:
        out["readings"] = r.readings
    out["checks"] = shown
    return out
