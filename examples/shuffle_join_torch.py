"""The paper's network use case on the port's copy of the shuffle
(``repro_torch.shuffle``): 6-node distributed shuffle with probe-table
build, sweeping zero-copy options (Fig. 11/12 in one run). The twin of
``examples/shuffle_join.py``; the shuffle is host code on the simulated
clock, so its rates are simulated, not measured on any device.

    PYTHONPATH=src python examples/shuffle_join_torch.py [--tuple-size 512]
"""

import argparse

from repro_torch.shuffle import ShuffleConfig, ShuffleSim

MiB = 1 << 20


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tuple-size", type=int, default=512)
    ap.add_argument("--workers", type=int, default=16)
    ap.add_argument("--mb-per-node", type=int, default=256)
    args = ap.parse_args(argv)

    print(f"{'mode':12s} {'GiB/s/node':>11s} {'Gbit/s':>8s} "
          f"{'mem GiB/s':>10s} {'mem/net':>8s} {'cpu%':>6s}")
    for zc_s, zc_r, label in [(False, False, "default"),
                              (True, False, "+zc_send"),
                              (True, True, "+zc_recv")]:
        cfg = ShuffleConfig(tuple_size=args.tuple_size,
                            n_workers=args.workers,
                            total_bytes_per_node=args.mb_per_node * MiB,
                            zc_send=zc_s, zc_recv=zc_r)
        r = ShuffleSim(cfg).run()
        print(f"{label:12s} {r['egress_gib_per_node']:11.1f} "
              f"{r['egress_gbit_per_node']:8.0f} {r['mem_gib_s']:10.1f} "
              f"{r['mem_per_net_byte']:8.2f} "
              f"{100*r['cpu_busy_frac']:6.1f}")


if __name__ == "__main__":
    main()
