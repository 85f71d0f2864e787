"""The port's examples run on the CPU: ``examples/serve_paged_torch.py``
(the twin of ``examples/serve_paged.py``) serves mixtral's smoke model,
pages KV through the buffer pool and prints the serving ladder; from its
pager section on, it prints what the JAX example prints, line for line
(both pagers and ladders run on the simulated clock).
``examples/train_lm_torch.py`` (the twin of ``examples/train_lm.py``)
trains on the ring loader; ``examples/quickstart_torch.py`` prints what
``examples/quickstart.py`` prints, and
``examples/storage_engine_ycsb_torch.py`` and ``examples/shuffle_join_torch.py``
what their JAX examples print, on the port's copies of the engines;
``scripts/sanity_models_torch.py`` and
``scripts/render_roofline_torch.py`` are the twins of their scripts."""

import importlib.util
import pathlib
import sys

import pytest

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


def test_quickstart_torch_prints_what_the_jax_quickstart_prints(capsys):
    """``examples/quickstart_torch.py`` (the twin of
    ``examples/quickstart.py``) on the port's copy of the ring runtime:
    the same lines, on the same simulated clock."""
    _load("quickstart_torch").main()
    torch_text = capsys.readouterr().out
    _load("quickstart").main()
    assert torch_text == capsys.readouterr().out
    assert torch_text.startswith("16 reads:")


@pytest.mark.parametrize("name,args,first", [
    ("storage_engine_ycsb", ["--txns", "300"], "config"),
    ("shuffle_join", ["--mb-per-node", "16"], "mode"),
])
def test_engine_example_twins_print_what_the_jax_examples_print(
        name, args, first, capsys, monkeypatch):
    """The Fig. 5 ladder and the zero-copy shuffle sweep, each on the
    port's copy of its engine: the JAX example's lines, line for line, on
    the same simulated clock."""
    _load(f"{name}_torch").main(args)
    torch_text = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", [name] + args)
    _load(name).main()
    assert torch_text == capsys.readouterr().out
    assert torch_text.split()[0] == first
    assert len(torch_text.splitlines()) > 3


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sanity_models_torch_passes_every_smoke_config(capsys):
    """``scripts/sanity_models_torch.py`` (the twin of
    ``scripts/sanity_models.py``): forward and 3 decode steps of every
    registered smoke config on the CPU, each line a PASS."""
    from repro_torch.configs import list_archs
    assert _script("sanity_models_torch").main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines] == \
        [["PASS", a] for a in list_archs()]


def test_render_roofline_torch_reads_the_dry_run(tmp_path, capsys):
    """``scripts/render_roofline_torch.py`` (the twin of
    ``scripts/render_roofline.py``) renders a 16 x 16 cell, with its
    roofline share at the H100's bf16 peak and its peak against 80 GB,
    lists a skipped cell and leaves out the multi-pod one."""
    import json
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    cell = {"arch": "a", "shape": "train_4k", "mesh": "16x16",
            "status": "ok", "kind": "train",
            "roofline": {"t_compute_s": 0.5, "t_memory_s": 1.0,
                         "t_collective_s": 0.25, "bottleneck": "memory",
                         "t_bound_s": 1.0},
            "model_flops_per_chip": 0.25 * PEAK_FLOPS_BF16,
            "useful_flops_frac": 0.5,
            "memory": {"peak_est_bytes": 90e9}}
    (tmp_path / "a_train_4k_16x16.json").write_text(json.dumps(cell))
    (tmp_path / "a_train_4k_2x16x16.json").write_text(json.dumps(
        dict(cell, mesh="2x16x16")))
    (tmp_path / "a_long_500k_16x16.json").write_text(json.dumps(
        {"arch": "a", "shape": "long_500k", "mesh": "16x16",
         "status": "skipped(full-attention)"}))
    _script("render_roofline_torch").main([str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[2] == ("| a | train_4k | 0.500 | 1.000 | 0.250 | memory "
                        "| 25.0% | 50% | 90.0 **over** |")
    assert lines[-1] == "- `a` × `long_500k`: **skipped(full-attention)**"
    assert len([ln for ln in lines if ln.startswith("| a |")]) == 1
