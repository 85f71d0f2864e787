"""End-to-end driver on the PyTorch/CUDA port (``src/repro_torch``): train
a small LM for a few hundred steps with the ring-based data pipeline and
group-commit checkpointing. The twin of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200   # card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

~100M params: --d-model 640 --layers 12. On the card attention runs the
flash forward and backward kernels; on the CPU their plain versions.
"""

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import RingLoader, TokenStore, make_synthetic_corpus
from repro_torch.train import TrainLoop, TrainLoopConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    heads = max(4, args.d_model // 64)
    cfg = get_smoke_config(args.arch).replace(
        n_layers=args.layers, d_model=args.d_model, n_heads=heads,
        n_kv_heads=heads, head_dim=args.d_model // heads,
        d_ff=args.d_model * 4, vocab_size=8192)
    n_params = cfg.n_params()
    print(f"arch={args.arch} params={n_params/1e6:.1f}M")

    tmp = args.ckpt_dir or tempfile.mkdtemp()
    corpus = make_synthetic_corpus(os.path.join(tmp, "tokens.bin"),
                                   2_000_000, cfg.vocab_size)
    loader = RingLoader(TokenStore(corpus), batch=args.batch, seq=args.seq,
                        prefetch=4)
    lc = TrainLoopConfig(total_steps=args.steps, ckpt_every=50,
                         ckpt_dir=os.path.join(tmp, "ckpt"), log_every=10)
    loop = TrainLoop(cfg, lc, loader, device=torch.device(args.device))
    loop.restore()
    t0 = time.time()
    final = loop.run()
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    print(f"done: loss={final['loss']:.3f} {dt:.0f}s "
          f"({toks/dt:.0f} tok/s) pipeline_enters={loader.stats.enters}")
    for m in loop.metrics_log[:3] + loop.metrics_log[-3:]:
        print("  ", m)
    return loop


if __name__ == "__main__":
    main()
