"""Fast sanity loop over all smoke configs on the port: forward + decode.
The twin of ``scripts/sanity_models.py``: the plain versions on the CPU
by default, the kernels with ``--device cuda``.

    PYTHONPATH=src python scripts/sanity_models_torch.py [--device cuda]
"""

import argparse
import sys
import traceback

import torch

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.models import lm
from repro_torch.tree import tree_leaves

B, S = 2, 64


def check(arch, device):
    """Forward over (B, S) and 3 decode steps of ``arch``'s smoke config:
    (params, logits shape, decode logits shape); a NaN raises."""
    cfg = get_smoke_config(arch)
    if device.type == "cuda" and cfg.hd not in (32, 64, 80, 128):
        cfg = cfg.replace(head_dim=32)      # a head dim the kernels take
    g = torch.Generator(device).manual_seed(0)
    params = lm.init_params(cfg, g, device=device)
    n = sum(t.numel() for t in tree_leaves(params))
    batch = {}
    if cfg.family == "vlm":
        batch["embeds"] = torch.randn((B, S, cfg.d_model), generator=g,
                                      device=device).to(torch.bfloat16)
        p1 = torch.arange(S, device=device)[None].expand(B, S)
        batch["pos3"] = torch.stack([p1, p1, p1])
    elif cfg.family == "audio":
        batch["tokens"] = torch.randint(0, cfg.vocab_size,
                                        (B, S, cfg.n_codebooks), generator=g,
                                        device=device)
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=g, device=device)
    with torch.no_grad():
        logits, _, _ = lm.forward(cfg, params, batch)
        assert not bool(torch.isnan(logits.float()).any()), "NaN"
        cache = lm.init_cache(cfg, S, B, device=device)
        tok = torch.zeros((B, 1, cfg.n_codebooks) if cfg.family == "audio"
                          else (B, 1), dtype=torch.int32, device=device)
        for i in range(3):
            lg, cache = lm.decode_step(cfg, params, cache, tok, i)
        assert not bool(torch.isnan(lg.float()).any()), "NaN decode"
    return n, tuple(logits.shape), tuple(lg.shape)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    ok = True
    for arch in list_archs():
        try:
            n, shape, dshape = check(arch, device)
            print(f"PASS {arch:24s} params={n:,} logits={shape} "
                  f"decode={dshape}")
        except Exception as e:  # noqa: BLE001 -- report every arch
            ok = False
            print(f"FAIL {arch}: {type(e).__name__}: {e}")
            traceback.print_exc(limit=8)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
