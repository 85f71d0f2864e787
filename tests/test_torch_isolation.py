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
    [ROOT / "chip_smoke.py"]


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
for arch in ("stablelm-1.6b", "zamba2-2.7b"):     # dense; hybrid (SSD too)
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
    from repro_torch.serve import ServeLoop
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
    }


@pytest.mark.parametrize("name", ["resolve_device", "init_params",
                                  "init_cache", "ServeLoop",
                                  "params_from_numpy", "TrainLoop"])
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
