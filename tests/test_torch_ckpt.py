"""The port's ring-backed checkpoints and data loader on the CPU: twins of
the JAX package's tests in ``test_substrate.py``, checkpoints that cross
between the two packages in both directions, and the port's copies of the
ring runtime and of the engines on it held to the text of the originals."""

import os
import pathlib
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_smoke_config as jax_smoke
from repro.models import lm as jlm
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import interop
from repro_torch.checkpoint import (Checkpointer, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.data import RingLoader, TokenStore, make_synthetic_corpus
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

ROOT = pathlib.Path(__file__).resolve().parents[1]
COPIED = ["core/sqe.py", "core/costs.py", "core/clock.py",
          "core/timeline.py", "core/backends.py", "core/ring.py",
          "observe/trace.py", "core/adaptive.py", "core/fibers.py",
          "core/faults.py", "observe/metrics.py", "observe/slo.py",
          "observe/advisor.py", "bufferpool/pool.py",
          "bufferpool/__init__.py", "core/perfmodel.py", "storage/btree.py",
          "wal/log.py", "wal/group_commit.py", "wal/recovery.py",
          "wal/__init__.py", "storage/engine.py", "storage/workloads.py",
          "storage/__init__.py", "lsm/memtable.py", "lsm/sstable.py",
          "lsm/compaction.py", "lsm/recovery.py", "lsm/engine.py",
          "lsm/__init__.py", "replication/frames.py",
          "replication/sender.py", "replication/standby.py",
          "replication/cluster.py", "replication/__init__.py",
          "shuffle/plan.py", "shuffle/sim.py", "shuffle/engine.py",
          "shuffle/__init__.py"]


@pytest.fixture
def tmpdir():
    d = tempfile.mkdtemp()
    yield d
    shutil.rmtree(d, ignore_errors=True)


def test_pipeline_token_integrity(tmpdir):
    """Twin of test_substrate.py::test_pipeline_token_integrity: corpus =
    arange -> every row consecutive ints, labels = tokens shifted by one."""
    path = os.path.join(tmpdir, "tok.bin")
    np.arange(100_000, dtype=np.int32).tofile(path)
    loader = RingLoader(TokenStore(path), batch=4, seq=32, prefetch=2)
    it = iter(loader)
    for _ in range(5):
        b = next(it)
        t, l = b["tokens"], b["labels"]
        assert t.shape == (4, 32) and l.shape == (4, 32)
        assert t.dtype == np.int32
        assert np.all(np.diff(t, axis=1) == 1)
        assert np.all(l == t + 1)
    assert loader.stats.batch_efficiency() > 1.5   # batched submission


def test_pipeline_hedged_reads_and_corpus(tmpdir):
    """LINK_TIMEOUT hedging leaves the rows intact; the synthetic corpus
    is the JAX package's (same seed, same tokens)."""
    from repro.data import make_synthetic_corpus as jax_corpus
    a = make_synthetic_corpus(os.path.join(tmpdir, "a.bin"), 5000, 384, 3)
    b = jax_corpus(os.path.join(tmpdir, "b.bin"), 5000, 384, 3)
    assert open(a, "rb").read() == open(b, "rb").read()
    path = os.path.join(tmpdir, "tok.bin")
    np.arange(50_000, dtype=np.int32).tofile(path)
    it = iter(RingLoader(TokenStore(path), batch=3, seq=16, prefetch=2,
                         hedge_timeout_s=1e-3))
    for _ in range(3):
        b = next(it)
        assert np.all(np.diff(b["tokens"], axis=1) == 1)
        assert np.all(b["labels"] == b["tokens"] + 1)


def test_checkpoint_roundtrip_and_retention(tmpdir):
    """Twin of test_substrate.py::test_checkpoint_roundtrip_and_retention,
    with a bf16 leaf and a 0-d int32 leaf."""
    tree = {"a": torch.arange(100, dtype=torch.float32).reshape(10, 10),
            "b": {"c": torch.ones((3,), dtype=torch.int32),
                  "d": torch.tensor(2.5),
                  "e": torch.linspace(-3, 3, 7).to(torch.bfloat16)},
            "s": torch.tensor(7, dtype=torch.int32)}
    for step in (10, 20, 30, 40):
        save_checkpoint(tmpdir, step, tree, keep=2)
    assert latest_step(tmpdir) == 40
    steps = [int(n.split("_")[1]) for n in os.listdir(tmpdir)
             if n.startswith("step_")]
    assert sorted(steps) == [30, 40]
    out = load_checkpoint(tmpdir, 40, tree)
    for l0, l1 in zip(tree_leaves(tree), tree_leaves(out)):
        assert l1.dtype == l0.dtype and l1.shape == l0.shape
        assert torch.equal(l0, l1)


def test_partial_checkpoint_invisible(tmpdir):
    """Twin of test_substrate.py::test_partial_checkpoint_invisible."""
    tree = {"a": torch.ones((4,))}
    save_checkpoint(tmpdir, 10, tree)
    os.makedirs(os.path.join(tmpdir, "step_20"))
    with open(os.path.join(tmpdir, "step_20", "data.bin"), "wb") as f:
        f.write(b"garbage")
    assert latest_step(tmpdir) == 10
    ck = Checkpointer(tmpdir, every=5)
    restored, step = ck.restore_or(tree)
    assert step == 10 and torch.equal(restored["a"], tree["a"])
    assert ck.maybe_save(0, tree) is None and ck.maybe_save(7, tree) is None
    assert ck.maybe_save(15, tree) is not None and latest_step(tmpdir) == 15


def test_flatten_order_is_jax_tree_flatten_order():
    """Dict keys sorted, NamedTuple fields in order: the same leaf list as
    ``jax.tree_util.tree_flatten`` of the same structure."""
    cfg = torch_smoke("stablelm-1.6b")
    jcfg = jax_smoke("stablelm-1.6b")
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = interop.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jtree = {"params": jp, "opt": jax_adamw_init(jp), "z": (1.0, [2, 3])}
    ttree = {"params": tp, "opt": adamw_init(tp), "z": (1.0, [2, 3])}
    jl = jax.tree_util.tree_leaves(jtree)
    tl, treedef = tree_flatten(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            assert a == b
    back = tree_unflatten(treedef, tl)
    assert type(back["opt"]).__name__ == "AdamWState"
    assert back["z"] == (1.0, [2, 3])


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_load_between_packages(tmpdir, param_dtype):
    """A checkpoint of params + AdamW state written by ``repro.checkpoint``
    loads in ``repro_torch.checkpoint``, and the reverse, bit for bit."""
    jcfg = jax_smoke("stablelm-1.6b").replace(param_dtype=param_dtype)
    tcfg = torch_smoke("stablelm-1.6b").replace(param_dtype=param_dtype)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    jo = jax_adamw_init(jp)
    jo = jo._replace(step=jnp.asarray(4, jnp.int32),
                     m=jax.tree_util.tree_map(lambda x: x + 0.5, jo.m))
    jtree = {"params": jp, "opt": jo}
    jax_save(os.path.join(tmpdir, "from_jax"), 4, jtree)

    from repro_torch.models import lm as tlm
    like_p = tlm.init_params(tcfg, torch.Generator().manual_seed(9),
                             device="cpu")
    like = {"params": like_p, "opt": adamw_init(like_p)}
    got = load_checkpoint(os.path.join(tmpdir, "from_jax"), 4, like)
    assert int(got["opt"].step) == 4
    for a, b in zip(jax.tree_util.tree_leaves(jtree), tree_leaves(got)):
        a = np.asarray(a)
        assert b.shape == a.shape and str(b.dtype)[6:] == a.dtype.name
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(b.numpy(), a)

    # the reverse: the port writes, the JAX package reads
    got["opt"].m["embed"].add_(1.0)
    save_checkpoint(os.path.join(tmpdir, "from_torch"), 5, got)
    back = jax_load(os.path.join(tmpdir, "from_torch"), 5, jtree)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(back)):
        b = np.asarray(b)
        assert b.dtype.name == str(a.dtype)[6:]
        if b.dtype.name == "bfloat16":
            np.testing.assert_array_equal(b.view(np.int16),
                                          a.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(b, a.numpy())


def _code_lines(text):
    """The lines of a module other than its import statements, at any
    indent (a function's, or a docstring's usage example), with the
    continuation lines of a parenthesised or backslash-continued one."""
    out, in_parens, continued = [], False, False
    for line in text.splitlines():
        if in_parens:
            in_parens = ")" not in line
        elif continued:
            continued = line.rstrip().endswith("\\")
        elif line.lstrip().startswith(("import ", "from ")):
            in_parens = "(" in line and ")" not in line
            continued = line.rstrip().endswith("\\")
        else:
            out.append(line)
    return out


@pytest.mark.parametrize("rel", COPIED)
def test_core_copy_equals_the_original_but_its_imports(rel):
    """The port's ring runtime is a copy: read as text, each file equals
    ``src/repro/<rel>`` except for its import lines (a docstring's usage
    example among them), which name ``repro_torch`` where the original
    names ``repro``."""
    orig = (ROOT / "src" / "repro" / rel).read_text()
    copy = (ROOT / "src" / "repro_torch" / rel).read_text()
    assert _code_lines(copy) == _code_lines(orig)
    imports = [l.lstrip() for l in copy.splitlines()
               if l.lstrip().startswith(("import ", "from "))]
    assert not any(l.split()[1].split(".")[0] == "repro" for l in imports)
    assert len(copy.splitlines()) == len(orig.splitlines())
