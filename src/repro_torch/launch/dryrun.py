"""Multi-pod dry run: trace every (arch × shape × mesh) cell's step on
fake tensors and count its roofline terms (the port's counterpart of
``repro/launch/dryrun.py``, which lowers and compiles each cell with XLA).

Each cell runs in a process of its own, which joins a fake process group
(``torch.testing._internal.distributed.fake_pg``) of 256 ranks (16 × 16)
or 512 (2 × 16 × 16) as rank 0, builds the production mesh and the
cell's shardings (``launch.steps.shardings_for_cell``), and makes its
inputs as fake local shards wrapped in DTensors
(``DTensor.from_local(..., run_check=False)``), never by
``distribute_tensor``: parameters, optimizer state, batch and cache hold
no memory and move no data. It then runs the cell's step under
``FakeTensorMode`` and ``roofline.counters.StepCounter``: train cells
``make_train_step`` (forward, remat recompute, backward, AdamW), prefill
cells ``make_prefill_step``, decode cells ``make_serve_step`` at
``pos = seq_len - 1`` (a full cache). The kernel ops take their fake
versions, the card's route, and count by ``roofline.work``.

``--device cuda`` (the sweep's numbers) needs a CUDA build of torch: fake
CUDA tensors and the mesh's collectives as on the card, and no card
memory used. ``--device cpu`` runs anywhere; there DTensor swaps a
Shard -> Shard all-to-all for an all-gather and a chunk, so its collective
records are not the card's.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
    python -m repro_torch.launch.dryrun --arch yi-34b --shape decode_32k \
        --multi-pod
    python -m repro_torch.launch.dryrun --all      # a process per cell
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

OUT_DIR = "experiments/dryrun_torch"


def _fake_leaf(abs_t, sharding, device):
    """A DTensor of ``abs_t``'s global shape and dtype placed by
    ``sharding``: a fake local shard of this rank's shape on ``device``."""
    import torch
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape = tuple(abs_t.shape)
    with unset_fake_temporarily():       # shapes, outside the fake mode
        local, _ = compute_local_shape_and_global_offset(
            shape, sharding.mesh, sharding.placements)
    t = torch.empty(tuple(local), dtype=abs_t.dtype, device=device)
    return DTensor.from_local(t, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _fake_tree(abs_tree, sh_tree, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda a, s: _fake_leaf(a, s, device), abs_tree, sh_tree)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS bookkeeping (JAX's dryrun.py:99-114): 6·N·D train,
    2·N·D forward-only; N excludes the input-embedding gather (the head
    matmul stays counted)."""
    from repro_torch.models.layers import padded_vocab
    n_active = cfg.n_params(active_only=True)
    embed_tab = padded_vocab(cfg.vocab_size) * cfg.d_model * \
        (cfg.n_codebooks or 1)
    n_eff = n_active - (0 if cfg.tie_embeddings else embed_tab)
    if shape.kind == "train":
        return 6 * n_eff * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2 * n_eff * shape.global_batch * shape.seq_len
    return 2 * n_eff * shape.global_batch


def trace_step(cfg, shape, mesh, device):
    """The cell's step traced on fake inputs under a ``StepCounter``:
    (counter, seconds, bytes held at the start by params, optimizer state
    and the rest of the inputs, CommDebugMode's collective counts by
    operator)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          make_train_step,
                                          shardings_for_cell)
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.roofline.counters import StepCounter

    sh = shardings_for_cell(cfg, shape, mesh)
    rules = sh["rules"]
    held = {}
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = _fake_tree(sh["params_abs"], sh["params_sh"], device)
        batch = _fake_tree(sh["batch_abs"], sh["batch_sh"], device)
        counter = StepCounter()
        held["params"] = counter.hold(params, "params")
        held["inputs"] = counter.hold(batch)
        if shape.kind == "train":
            oa, osh = sh["opt_abs"], sh["opt_sh"]
            opt = AdamWState(step=_fake_leaf(oa.step, osh.step, device),
                             m=_fake_tree(oa.m, osh.m, device),
                             v=_fake_tree(oa.v, osh.v, device))
            held["opt"] = counter.hold(opt, "optimizer state")
        elif shape.kind == "decode":
            cache = _fake_tree(sh["cache_abs"], sh["cache_sh"], device)
            held["inputs"] += counter.hold(cache)
        t0 = time.perf_counter()
        with CommDebugMode() as comm, counter:
            if shape.kind == "train":
                make_train_step(cfg, mesh, rules)(params, opt, batch)
            elif shape.kind == "prefill":
                with torch.no_grad():
                    make_prefill_step(cfg, mesh, rules)(params, batch)
            else:
                with torch.no_grad():
                    make_serve_step(cfg, mesh, rules)(
                        params, cache, batch["tokens"], shape.seq_len - 1)
        secs = time.perf_counter() - t0
    return counter, secs, held, {str(k): v for k, v in
                                 comm.get_comm_counts().items()}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             overrides: dict | None = None, tag: str = "",
             device: str = "cuda", mesh_shape=None, config=None) -> dict:
    """One cell in this process, which must own no process group yet: the
    fake group, the mesh (the production mesh, or ``mesh_shape`` =
    (shape, axes) for a smaller one), the trace and its counts; writes
    ``<arch>_<shape>_<mesh>[_<tag>].json`` under ``out_dir``.
    ``shape_name`` may be a ``ShapeConfig`` and ``config`` a
    ``ModelConfig`` (a smoke cell) in place of the registered ones."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.roofline import collective_bytes_moved, roofline_terms
    from repro_torch.roofline.counters import BYTES_RULE

    cfg = config if config is not None else get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": why}
    if mesh_shape is None:
        mesh_shape = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
            else ((16, 16), ("data", "model"))
    dims, axes = mesh_shape
    n_chips = 1
    for d in dims:
        n_chips *= d
    mesh_name = "x".join(map(str, dims))
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n_chips)
    mesh = mesh_mod.make_mesh(dims, axes, device=device)

    counter, trace_s, held, comm_counts = trace_step(cfg, shape, mesh,
                                                     device)
    coll_moved, by_kind = collective_bytes_moved(counter.records)
    internode = sum(k["moved_internode"] for k in by_kind.values())
    flops, n_bytes = counter.flops, counter.bytes
    terms = roofline_terms(hlo_flops=flops, hlo_bytes=n_bytes,
                           coll_moved=coll_moved,
                           coll_moved_internode=internode, n_chips=n_chips)
    mf = model_flops(cfg, shape) / n_chips
    peak = counter.peak
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "tag": tag, "n_chips": n_chips, "kind": shape.kind,
        "trace_s": round(trace_s, 1),
        "flops_per_device": flops,
        "bytes_per_device": n_bytes,
        "collective_moved_per_device": coll_moved,
        "collective_moved_internode_per_device": internode,
        "collectives": by_kind,
        # CommDebugMode's count of the same trace, by operator: its sum
        # equals the records' count where the two saw the same operators
        "comm_debug_counts": comm_counts,
        "comm_debug_agrees": sum(comm_counts.values()) ==
        len(counter.records),
        "kernel_ops": counter.kernel_ops(),
        "while_without_trip": 0,
        "memory": {
            "params_bytes": held.get("params", 0),
            "opt_bytes": held.get("opt", 0),
            "inputs_bytes": held.get("inputs", 0),
            "rest_bytes": peak - sum(held.values()),
            "peak_est_bytes": peak,
            "peak_holders": counter.peak_holders(),
        },
        "roofline": terms,
        "model_flops_per_chip": mf,
        "useful_flops_frac": (mf / flops) if flops else 0,
        "overrides": overrides or {},
        "mesh_device": device,
        "torch": torch.__version__,
        "bytes_rule": BYTES_RULE,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        fn = os.path.join(out_dir, f"{arch}_{shape_name}_{mesh_name}"
                          f"{suffix}.json")
        with open(fn, "w") as f:
            json.dump(result, f, indent=1)
    return result


def _cell_cmd(arch, shape_name, multi, out_dir, device):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape_name, "--out", out_dir, "--device", device]
    return cmd + (["--multi-pod"] if multi else [])


def sweep(out_dir: str, multi_pod_too: bool = True, archs=None,
          device: str = "cuda", jobs: int = 1):
    """A process per cell (a fake group is process-wide), ``jobs`` at
    once; skipped cells are written as the JAX package writes them."""
    from repro_torch.configs import cells
    todo = []
    for arch, shape_name, ok, why in cells(include_skipped=True):
        if archs and arch not in archs:
            continue
        for m in [False] + ([True] if multi_pod_too else []):
            mesh_name = "2x16x16" if m else "16x16"
            if not ok:
                os.makedirs(out_dir, exist_ok=True)
                with open(os.path.join(
                        out_dir, f"{arch}_{shape_name}_{mesh_name}.json"),
                        "w") as f:
                    json.dump({"arch": arch, "shape": shape_name,
                               "mesh": mesh_name, "status": why}, f)
                print(f"{arch} {shape_name} {mesh_name}: {why}", flush=True)
                continue
            todo.append((arch, shape_name, m))

    def run(item):
        arch, shape_name, m = item
        t0 = time.time()
        r = subprocess.run(_cell_cmd(arch, shape_name, m, out_dir, device),
                           capture_output=True, text=True)
        return item, r, time.time() - t0

    failed = []
    with ThreadPoolExecutor(max(1, jobs)) as pool:
        for i, (item, r, dt) in enumerate(pool.map(run, todo)):
            label = f"[{i + 1}/{len(todo)}] {' '.join(map(str, item))}"
            if r.returncode == 0:
                print(f"{label}: ok ({dt:.0f}s)", flush=True)
            else:
                print(f"{label}: FAIL ({dt:.0f}s)\n{r.stdout[-2000:]}"
                      f"\n{r.stderr[-4000:]}", flush=True)
                failed.append(item)
    if failed:
        print(f"FAILED cells: {failed}", flush=True)
        return 1
    print("sweep complete", flush=True)
    return 0


def _parse_overrides(text):
    overrides = {}
    for kv in filter(None, text.split(",")):
        k, v = kv.split("=")
        if v in ("True", "False"):
            v = v == "True"
        else:
            for conv in (int, float):
                try:
                    v = conv(v)
                    break
                except ValueError:
                    pass
        overrides[k] = v
    return overrides


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--archs", default="",
                    help="comma list filter for --all")
    ap.add_argument("--tag", default="", help="variant tag for the output")
    ap.add_argument("--override", default="",
                    help="cfg overrides k=v[,k=v]; ints/floats/bools parsed")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' and the mesh's device")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once by --all")
    args = ap.parse_args()

    if args.all:
        sys.exit(sweep(args.out, archs=[a for a in args.archs.split(",")
                                        if a],
                       device=args.device, jobs=args.jobs))
    try:
        r = run_cell(args.arch, args.shape, args.multi_pod, args.out,
                     _parse_overrides(args.override) or None, args.tag,
                     device=args.device)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    print(json.dumps({k: v for k, v in r.items()
                      if k not in ("collectives", "kernel_ops",
                                   "bytes_rule")}, indent=1))
    sys.exit(0 if r.get("status", "ok").startswith("ok") or
             "skipped" in r.get("status", "") else 1)


if __name__ == "__main__":
    main()
