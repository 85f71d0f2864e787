"""The port stands alone: it imports neither JAX nor the ``repro`` package,
it serves and trains with JAX unimportable, and its entry points refuse
to run without a card unless the caller asks for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py")) + \
    sorted((ROOT / "examples").glob("*_torch.py")) + \
    sorted((ROOT / "scripts").glob("*_torch.py"))


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_repro(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_serves_with_jax_unimportable():
    code = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises
import numpy as np, torch
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.serve import ServeLoop
for arch in ("stablelm-1.6b", "zamba2-2.7b",      # dense; hybrid (SSD too)
             "mixtral-8x22b", "deepseek-v2-lite-16b"):        # moe; MLA
    cfg = get_smoke_config(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    out = ServeLoop(cfg, params, max_len=32, device="cpu").generate(prompt, 4)
    assert tuple(out.shape) == (2, 4)
    assert ((out >= 0) & (out < cfg.vocab_size)).all()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("repro", "jaxlib")
             or (m.startswith("jax") and sys.modules[m] is not None))
assert not bad, bad
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "OK", res.stderr


def test_new_families_and_pager_with_jax_unimportable():
    """vlm and audio serve, and the KV pager (on its copies of the ring
    runtime, the buffer pool and the metrics) pages and hands its pools
    over, while any ``import jax`` raises."""
    code = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises
import numpy as np, torch
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.serve import KVPager, PagerConfig, ServeLoop
for arch, shape in (("qwen2-vl-2b", (2, 16)), ("musicgen-large", (2, 16, 4))):
    cfg = get_smoke_config(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, shape)
    out = ServeLoop(cfg, params, max_len=32, device="cpu").generate(prompt, 4)
    assert tuple(out.shape) == (2, 4) + shape[2:]
p = KVPager(PagerConfig(n_hbm_pages=4, page_tokens=4, kv_heads=2,
                        head_dim=8, host_pages=4))
for b in range(12):
    p.put_page_sync((0, b), torch.randn(4, 2, 8), torch.randn(4, 2, 8))
assert p.pool.writebacks > 0 and p.spilled_pages() > 0
k, v = p.device_pools(device="cpu")
assert k.shape == (4, 4, 2, 8) and k.dtype == torch.bfloat16
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("repro", "jaxlib")
             or (m.startswith("jax") and sys.modules[m] is not None))
assert not bad, bad
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "OK", res.stderr


def test_trains_with_jax_unimportable(tmp_path):
    """One smoke ``TrainLoop`` step on the CPU from a ring-backed loader,
    with a ring checkpoint, while any ``import jax`` raises."""
    code = f"""
import os, sys
sys.modules["jax"] = None          # any `import jax` now raises
import numpy as np, torch
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_smoke_config
from repro_torch.data import RingLoader, TokenStore, make_synthetic_corpus
from repro_torch.train import TrainLoop, TrainLoopConfig
cfg = get_smoke_config("stablelm-1.6b")
path = make_synthetic_corpus(os.path.join({str(tmp_path)!r}, "tok.bin"),
                             10_000, cfg.vocab_size)
ckpt = os.path.join({str(tmp_path)!r}, "ckpt")
loop = TrainLoop(cfg, TrainLoopConfig(total_steps=2, ckpt_every=1,
                                      ckpt_dir=ckpt, log_every=1),
                 RingLoader(TokenStore(path), batch=2, seq=16),
                 device="cpu")
last = loop.run()
assert last["step"] == 1 and np.isfinite(last["loss"]), last
assert latest_step(ckpt) == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("repro", "jaxlib")
             or (m.startswith("jax") and sys.modules[m] is not None))
assert not bad, bad
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "OK", res.stderr


def _entry_points():
    from repro_torch import interop, resolve_device
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.serve import KVPager, PagerConfig, ServeLoop
    from repro_torch.train import TrainLoop, TrainLoopConfig
    cfg = get_smoke_config("stablelm-1.6b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return {
        "resolve_device": lambda: resolve_device(),
        "init_params": lambda: lm.init_params(cfg, torch.Generator()),
        "init_cache": lambda: lm.init_cache(cfg, 32, 2),
        "ServeLoop": lambda: ServeLoop(cfg, params, max_len=32),
        "params_from_numpy": lambda: interop.params_from_numpy(
            cfg, {k: v for k, v in params.items()}),
        "TrainLoop": lambda: TrainLoop(cfg, TrainLoopConfig(), iter(())),
        "KVPager.device_pools": lambda: KVPager(PagerConfig(
            n_hbm_pages=4, page_tokens=4, kv_heads=2,
            head_dim=8)).device_pools(),
    }


@pytest.mark.parametrize("name", ["resolve_device", "init_params",
                                  "init_cache", "ServeLoop",
                                  "params_from_numpy", "TrainLoop",
                                  "KVPager.device_pools"])
def test_entry_points_need_a_card_unless_asked_for_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_lib_path_follows_included_headers(monkeypatch, tmp_path):
    """A library is keyed by its source and every header it includes (as
    the flash sources include csrc/hopper.cuh): editing a header, even one
    included by a header, gives a new path, so a stale build is never
    loaded; a header the source does not include changes nothing."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n'
                                   "int f() { return g(); }\n")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n'
                                    "int g() { return h(); }\n")
    (tmp_path / "b.cuh").write_text("int h() { return 1; }\n")
    (tmp_path / "other.cuh").write_text("int x;\n")
    first = _build.lib_path("k")
    assert _build.lib_path("k") == first
    (tmp_path / "other.cuh").write_text("int y;\n")
    assert _build.lib_path("k") == first
    (tmp_path / "b.cuh").write_text("int h() { return 2; }\n")
    second = _build.lib_path("k")
    assert second != first
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n'
                                    "int g() { return h() + 1; }\n")
    assert _build.lib_path("k") not in (first, second)
    # the real sources: both flash libraries follow the shared header
    monkeypatch.undo()
    assert b"hopper.cuh" in (_build.CSRC / "flash_fwd.cu").read_bytes()
    src = _build._source_bytes(_build.CSRC / "flash_bwd.cu", set())
    assert (_build.CSRC / "hopper.cuh").read_bytes() in src
