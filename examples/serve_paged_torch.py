"""Serve a small model with batched requests + paged KV cache demo, on the
PyTorch/CUDA port (``src/repro_torch``): the twin of
``examples/serve_paged.py``.

    PYTHONPATH=src python examples/serve_paged_torch.py              # card
    PYTHONPATH=src python examples/serve_paged_torch.py --device cpu

On the card the serving loop runs the flash and paged kernels, and the
paged attention over the pager's frames runs the paged kernel; on the CPU
each runs its plain PyTorch version. The serving ladder runs on the
pager's simulated clock on either device.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.paged_attn.ops import paged_attention
from repro_torch.models import lm
from repro_torch.serve import KVPager, PagerConfig, ServeLoop


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # mixtral's smoke config: the kernels take no head dim 16, so on the
    # card its heads are 32 wide
    cfg = get_smoke_config("mixtral-8x22b")
    if dev.type == "cuda":
        cfg = cfg.replace(head_dim=32)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    sv = ServeLoop(cfg, params, max_len=96, device=dev)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 24)).astype(np.int32)
    out = sv.generate(prompts, 16)
    print("batched generate:", tuple(out.shape))
    print("first request tokens:", out[0].cpu().numpy())

    # --- paged KV on the buffer pool (the buffer manager for serving) --
    pcfg = PagerConfig(n_hbm_pages=16, page_tokens=16, kv_heads=2,
                       head_dim=32)
    pager = KVPager(pcfg)
    gen = torch.Generator().manual_seed(0)
    for blk in range(48):                      # 3x oversubscription
        kp = torch.randn((16, 2, 32), generator=gen).to(torch.bfloat16)
        pager.put_page_sync((0, blk), kp, kp)
    print(f"pager: hbm_pages={pcfg.n_hbm_pages} written=48 "
          f"spilled={pager.spilled_pages()} faults={pager.faults} "
          f"writebacks={pager.pool.writebacks}")
    slots = [pager.fix_page_sync((0, b)) for b in (0, 13, 26, 39)]
    k_pool, v_pool = pager.device_pools(dev)
    q = torch.randn((1, 4, 32), generator=gen).to(dev)
    out = paged_attention(q, k_pool.float(), v_pool.float(),
                          torch.tensor([slots], dtype=torch.int32,
                                       device=dev),
                          torch.tensor([64], dtype=torch.int32, device=dev))
    for s in slots:
        pager.pool.unfix(s)
    print("paged attention over spilled+restored pages:", tuple(out.shape),
          f"faults={pager.faults} ring_enters={pager.ring.stats.enters}")

    # --- the serving ladder on a miss-heavy decode (tiny sweep; the
    # full calibrated sweep lives in benchmarks/bench_serve.py) --------
    print("serving ladder (miss-heavy decode, NVMe cold tier; simulated):")
    for c in PagerConfig.ladder(prefetch_k=4, n_hbm_pages=24,
                                host_pages=8, nvme_pages=256,
                                page_tokens=8, head_dim=16):
        p = KVPager(c)
        p.prefill(n_seqs=2, n_blocks=32, seed=1)
        r = p.run_decode(n_tokens=2)
        print(f"  {c.name:>14s} {r['tok_s']:8.0f} tok/s  "
              f"demand={r['demand_faults']:4d} "
              f"prefetch={r['prefetch_reads']:4d} "
              f"passthru={r['passthru_cmds']:4d}")
    return out


if __name__ == "__main__":
    main()
