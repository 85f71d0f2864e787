"""The paper's buffer-manager use case end-to-end, on the port's copies of
the storage engine and the analytic models (``repro_torch.storage``,
``repro_torch.core.perfmodel``): run the Fig. 5 design ladder on YCSB and
print measured vs modeled throughput. The twin of
``examples/storage_engine_ycsb.py``; the engine is host code on the
simulated clock, so tx/s is simulated, not a time on any device.

    PYTHONPATH=src python examples/storage_engine_ycsb_torch.py [--txns 3000]
"""

import argparse
from dataclasses import replace

from repro_torch.core.perfmodel import (CycleModel, LatencyModel, PAPER_C_TX,
                                        PAPER_C_READ_BATCH,
                                        PAPER_C_WRITE_BATCH)
from repro_torch.storage.engine import EngineConfig, StorageEngine
from repro_torch.storage.workloads import ycsb_update_txn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--txns", type=int, default=3000)
    args = ap.parse_args(argv)

    print(f"{'config':14s} {'tx/s':>10s} {'fault':>6s} {'enters':>7s} "
          f"{'batch':>6s} {'workers':>8s}")
    for cfg in EngineConfig.ladder():
        # Fig. 5 is the non-durable single-core ladder
        if cfg.durability != "none" or cfg.n_cores > 1:
            continue
        cfg = replace(cfg, pool_frames=2048)   # ladder() configs are
        eng = StorageEngine(cfg, n_tuples=200_000)  # shared: never mutate
        res = eng.run_fibers(lambda rng, e=eng: ycsb_update_txn(e, rng),
                             args.txns)
        fault = res["faults"] / max(1, res["faults"] + res["hits"]) * 3
        print(f"{cfg.name:14s} {res['tps']:10.0f} {fault:6.2f} "
              f"{res['enters']:7d} {res['batch_eff']:6.1f} "
              f"{res['worker_fallbacks']:8d}")
    lat = LatencyModel(page_fault_rate=0.7).tx_per_s()
    cyc = CycleModel(PAPER_C_TX, PAPER_C_READ_BATCH + PAPER_C_WRITE_BATCH,
                     0.7).tx_per_s()
    print(f"\nanalytic models (paper §3.2): latency-bound={lat:.0f} tx/s, "
          f"cycle-bound={cyc:.0f} tx/s")


if __name__ == "__main__":
    main()
