"""The port's examples run on the CPU: ``examples/serve_paged_torch.py``
(the twin of ``examples/serve_paged.py``) serves mixtral's smoke model,
pages KV through the buffer pool and prints the serving ladder; from its
pager section on, it prints what the JAX example prints, line for line
(both pagers and ladders run on the simulated clock).
``examples/train_lm_torch.py`` (the twin of ``examples/train_lm.py``)
trains on the ring loader."""

import importlib.util
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _from_pager(text):
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("pager:"))
    return [ln.replace("; simulated", "") for ln in lines[start:]]


def test_serve_paged_torch_example_runs_on_cpu(capsys):
    out = _load("serve_paged_torch").main(["--device", "cpu"])
    torch_text = capsys.readouterr().out
    assert "batched generate: (4, 16)" in torch_text
    assert tuple(out.shape) == (1, 4, 32)
    _load("serve_paged").main()
    jax_text = capsys.readouterr().out
    assert _from_pager(torch_text) == _from_pager(jax_text)
    assert len(_from_pager(torch_text)) == 8          # 2 pager + 6 ladder


def test_train_lm_torch_example_runs_on_cpu(capsys, tmp_path):
    """``examples/train_lm_torch.py`` (the twin of ``examples/train_lm.py``)
    trains a few steps on the CPU from the ring loader and logs every
    tenth step and the last."""
    args = ["--device", "cpu", "--steps", "3", "--d-model", "64",
            "--layers", "2", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path)]
    loop = _load("train_lm_torch").main(args)
    text = capsys.readouterr().out
    assert text.startswith("arch=stablelm-1.6b params=")
    assert "done: loss=" in text
    assert [m["step"] for m in loop.metrics_log] == [0, 2]
    assert all(m["loss"] > 0 for m in loop.metrics_log)
