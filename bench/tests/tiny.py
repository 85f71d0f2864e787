"""A benchmark at a size the CPU runs in seconds, written into a folder
of its own: a configuration, traffic mixes and limits of the same kinds
as the real cells', and copies of the real metric readers."""

import hashlib
import json
import pathlib
import shutil

BENCH = pathlib.Path(__file__).resolve().parents[1]

MLA_MOE = {
    "family": "moe", "n_layers": 3, "d_model": 64, "n_heads": 4,
    "n_kv_heads": 4, "head_dim": 16, "d_ff": 128, "vocab_size": 256,
    "rope_theta": 10000, "norm_eps": 1e-06, "swa_window": 0,
    "compute_dtype": "bfloat16",
    "moe": {"n_experts": 8, "n_shared": 1, "top_k": 2, "d_ff_expert": 32,
            "first_k_dense": 1, "capacity_factor": 1.25,
            "router_aux_weight": 0.01, "expert_split": 2},
    "mla": {"kv_lora_rank": 32, "qk_nope_head_dim": 16,
            "qk_rope_head_dim": 8, "v_head_dim": 16}}

GQA_MOE = {
    "family": "moe", "n_layers": 2, "d_model": 64, "n_heads": 4,
    "n_kv_heads": 2, "head_dim": 16, "d_ff": 64, "vocab_size": 256,
    "rope_theta": 1000000.0, "norm_eps": 1e-05, "swa_window": 0,
    "compute_dtype": "bfloat16",
    "moe": {"n_experts": 4, "n_shared": 0, "top_k": 2, "d_ff_expert": 64,
            "first_k_dense": 0, "capacity_factor": 1.25,
            "router_aux_weight": 0.01, "expert_split": 4}}

SERVE = {"kind": "serve", "batch": 3, "n_new": 5,
         "loguniform": {"lo": 9, "hi": 40, "n": 4, "mix_seed": 1},
         "check_units": 2, "trace_units": 2}
PREFILL = {"kind": "serve", "batch": 1, "n_new": 1,
           "loguniform": {"lo": 20, "hi": 70, "n": 5, "mix_seed": 2},
           "check_units": 3, "trace_units": 3}
TRAIN = {"kind": "train", "batch": 2, "seq": 32, "corpus_tokens": 4096,
         "chunk_steps": 2, "reference_steps": 3, "trace_units": 1,
         "optimizer": {"peak_lr": 0.0003, "warmup": 100, "total": 10000,
                       "floor": 0.1, "b1": 0.9, "b2": 0.95, "eps": 1e-08,
                       "weight_decay": 0.1, "clip": 1.0}}

# limits for the tiny cells, set for the program computing in fp32 (its
# readings: served gaps up to 0.013, from its bf16 decode caches; loss,
# gradient and change gaps under 1e-4); at d_model 64 a bf16 program's
# route flips move tokens too often for a limit to part it from fp8
SERVE_LIMITS = {"numbers": {"logit_gap_max": {"limit": 0.05}}}
TRAIN_LIMITS = {"numbers": {"loss_gap": {"limit": 1e-4},
                            "grad_gap": {"limit": 1e-3},
                            "change_gap": {"limit": 1e-3}}}


def write(root: pathlib.Path, compute="bfloat16") -> pathlib.Path:
    """A BENCHMARK.json with three tiny cells under ``root``; returns the
    path of the BENCHMARK.json."""
    real = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    data = root / "tinybench"
    for d in ("configs", "traffic", "limits"):
        (data / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", data / "metrics")
    for name, m in (("tiny-mla", MLA_MOE), ("tiny-gqa", GQA_MOE)):
        (data / "configs" / f"{name}.json").write_text(
            json.dumps({"model": dict(m, compute_dtype=compute)}))
    for name, t in (("serve", SERVE), ("prefill", PREFILL),
                    ("train", TRAIN)):
        (data / "traffic" / f"{name}.json").write_text(json.dumps(t))
    cells = [("mla-serve", "tiny-mla", "serve", SERVE_LIMITS),
             ("gqa-serve", "tiny-gqa", "serve", SERVE_LIMITS),
             ("mla-prefill", "tiny-mla", "prefill", SERVE_LIMITS),
             ("mla-train", "tiny-mla", "train", TRAIN_LIMITS)]
    for name, _, _, lim in cells:
        (data / "limits" / f"{name}.json").write_text(json.dumps(lim))
    spec = dict(real)
    spec["configs"] = [{"name": n, "source": "test", "reduced": [], "why": "t",
                        "file": f"tinybench/configs/{n}.json"}
                       for n in ("tiny-mla", "tiny-gqa")]
    spec["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                          "why": "test"} for n, c, t, _ in cells]
    e2e = {"mla-serve": "decode_tokens_per_s", "gqa-serve":
           "decode_tokens_per_s", "mla-prefill": "ttft_ms_p95",
           "mla-train": "train_tokens_per_s"}
    for e in spec["end_to_end"]:
        if "workloads" in e:
            e["workloads"] = [c for c, n in e2e.items() if n == e["name"]]
    by_moved = {}
    for c, n in e2e.items():
        by_moved.setdefault(n, []).append(c)
    for p in spec["per_layer"]:
        p["workloads"] = by_moved.get(p["moves"], [])
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path


def harness_digest() -> dict:
    """The harness's code: every file a new cell, configuration or model
    module must leave as it is."""
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(BENCH.glob("*.py")) + sorted(
                BENCH.glob("reference/*.py"))}
