"""The port's training path on the CPU against the JAX package: AdamW and
its schedule, gradient compression, train steps from the same weights and
batches, microbatching, remat, and a restart from a checkpoint. JAX
weights are carried over through numpy (``repro_torch.interop``); the
flash kernels run their plain versions on CPU tensors."""

import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import lm as jlm
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import cosine_schedule as jax_cosine
from repro_torch import interop
from repro_torch.checkpoint import latest_step, load_checkpoint, \
    save_checkpoint
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.optim.compression import (compress_decompress, ef_init,
                                           wire_bytes)
from repro_torch.tree import tree_leaves, tree_map

ARCH = "stablelm-1.6b"
# Train steps against JAX from the same weights and batches. Each step's
# gradients are compared elementwise, relative to the largest magnitude of
# their leaf ("grads"), and the parameters after the steps by the relative
# L2 error of each leaf ("params"), not elementwise: AdamW's first steps
# move a parameter by about lr whatever its gradient's size, so a gradient
# element near 0 whose last bits differ can move its parameter by up to
# 2·lr in one package and not the other (a few elements in 10^4 at lr
# 1e-2; after one step at lr 1e-2 that is up to 6e-5 of a leaf's norm).
# fp32 compute differs by summation order only (measured: grads 1.6e-6 at
# the first step, 1.1e-5 at the third, params 2.2e-6 after three steps
# warming up to lr 1e-2). bf16 rounds activations at other places in the
# two frameworks, so its gradients are compared at the first step only,
# from the same weights (measured: grads 1.8e-2, loss 8.6e-4, params
# 2.9e-2 after three steps).
STEP_TOLS = {"float32": {"loss": 1e-5, "grad_norm": 1e-5, "grads": 5e-5,
                         "params": 1e-5},
             "bfloat16": {"loss": 5e-3, "grad_norm": 2e-2, "grads": 5e-2,
                          "params": 1e-1}}
ONE_STEP_PARAMS = 2e-4        # params after one fp32 step at lr 1e-2


@pytest.fixture
def tmpdir():
    d = tempfile.mkdtemp()
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _cfgs(arch=ARCH, **kw):
    return jax_smoke(arch).replace(**kw), torch_smoke(arch).replace(**kw)


def _weights(jcfg, tcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = interop.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


def _batch(cfg, i, B=2, S=32):
    t = np.random.default_rng(100 + i).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": t, "labels": np.roll(t, -1, axis=1)}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _jax_loss_and_grads(cfg, params, b):
    from repro.launch.steps import ce_loss
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    return jax.value_and_grad(lambda p: ce_loss(
        cfg, jlm.forward(cfg, p, jb)[0], jb["labels"]))(params)


def _assert_scaled_close(tt, jt, tol, what):
    """Every element within tol × the largest |value| of its leaf."""
    tl, jl = tree_leaves(tt), jax.tree_util.tree_leaves(jt)
    assert len(tl) == len(jl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        a, b = a.detach().double().numpy(), np.asarray(b, np.float64)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert err <= tol, f"{what} leaf {i}: {err:.3e} > {tol}"


def _assert_rel_l2(tt, jt, tol, what):
    """Each leaf's ‖t − j‖ / ‖j‖ within tol."""
    tl, jl = tree_leaves(tt), jax.tree_util.tree_leaves(jt)
    assert len(tl) == len(jl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        a, b = a.detach().double().numpy(), np.asarray(b, np.float64)
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= tol, f"{what} leaf {i}: {err:.3e} > {tol}"


def _assert_tree_close(tt, jt, tol, what):
    tl, jl = tree_leaves(tt), jax.tree_util.tree_leaves(jt)
    assert len(tl) == len(jl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), atol=tol,
                                   rtol=tol, err_msg=f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# optimizer and compression
# ---------------------------------------------------------------------------

def test_adamw_against_numpy_reference():
    """Twin of test_substrate.py::test_adamw_against_numpy_reference."""
    p = {"w": torch.tensor([[1.0, -2.0], [0.5, 3.0]])}
    g = {"w": torch.tensor([[0.1, 0.2], [-0.3, 0.4]])}
    p0 = p["w"].clone()                        # the update is in place
    st = adamw_init(p)
    p2, st2, gn = adamw_update(g, st, p, lr=0.1, weight_decay=0.0,
                               clip_norm=1e9)
    gw = g["w"].numpy()
    m = 0.1 * gw / (1 - 0.9)
    v = 0.05 * gw ** 2 / (1 - 0.95)
    exp = p0.numpy() - 0.1 * m / (np.sqrt(v) + 1e-8)
    np.testing.assert_allclose(p2["w"].numpy(), exp, atol=1e-6)
    np.testing.assert_allclose(float(gn), np.linalg.norm(gw), atol=1e-6)
    assert p2["w"] is p["w"] and int(st2.step) == 1
    assert st2.step.dtype == torch.int32 and st2.step.shape == ()


def test_adamw_matches_jax_with_decay_and_clipping():
    """Weight decay only on leaves of 2+ dims, clipping at 1.0, three
    steps, against ``repro.optim.adamw_update``."""
    from repro.optim import adamw_update as jax_update
    rng = np.random.default_rng(0)
    p = {"a": rng.standard_normal((4, 3), dtype=np.float32),
         "b": rng.standard_normal((3,), dtype=np.float32)}
    jp, jst = {k: jnp.asarray(v) for k, v in p.items()}, None
    jst = jax_adamw_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    tst = adamw_init(tp)
    for i in range(3):
        g = {k: rng.standard_normal(v.shape, dtype=np.float32) * 3
             for k, v in p.items()}
        jp, jst, jn = jax_update({k: jnp.asarray(v) for k, v in g.items()},
                                 jst, jp, lr=0.05)
        tp, tst, tn = adamw_update({k: torch.from_numpy(v)
                                    for k, v in g.items()}, tst, tp, lr=0.05)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_tree_close(tp, jp, 1e-6, f"params step {i}")
        _assert_tree_close(tst.m, jst.m, 1e-6, f"m step {i}")
        _assert_tree_close(tst.v, jst.v, 1e-6, f"v step {i}")


def test_cosine_schedule_shape():
    """Twin of test_substrate.py::test_cosine_schedule_shape, and the same
    values as the JAX schedule."""
    lrs = [float(cosine_schedule(torch.tensor(s), peak_lr=1.0, warmup=10,
                                 total=100)) for s in range(100)]
    assert lrs[0] < lrs[9]                 # warmup rises
    assert abs(lrs[10] - 1.0) < 0.05       # peak
    assert lrs[-1] < 0.2                   # decays toward floor*peak
    assert min(lrs[10:]) >= 0.099          # floor
    want = [float(jax_cosine(jnp.asarray(s), peak_lr=1.0, warmup=10,
                             total=100)) for s in range(100)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6)


def test_gradient_compression_error_feedback():
    """Twin of test_substrate.py::test_gradient_compression_error_feedback:
    after N steps, sum(compressed) ~= sum(true) despite int8 rounding."""
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(
        rng.standard_normal((64, 64), dtype=np.float32) * 0.01)}
    ef = ef_init(tree)
    acc_true = np.zeros((64, 64))
    acc_hat = np.zeros((64, 64))
    for i in range(20):
        g = {"w": torch.from_numpy(
            rng.standard_normal((64, 64), dtype=np.float32) * 0.01)}
        g_hat, ef = compress_decompress(g, ef)
        acc_true += g["w"].numpy()
        acc_hat += g_hat["w"].numpy()
    resid = np.abs(acc_true - acc_hat).max()
    assert resid < 5e-4, resid
    assert wire_bytes(tree) == 64 * 64 * 4


def test_compression_matches_jax():
    """One compress/decompress of the same gradients and residuals."""
    from repro.optim.compression import compress_decompress as jax_cd
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((8, 8), dtype=np.float32),
         "b": rng.standard_normal((5,), dtype=np.float32) * 1e-3}
    e = {k: rng.standard_normal(v.shape, dtype=np.float32) * 0.01
         for k, v in g.items()}
    jh, je = jax_cd({k: jnp.asarray(v) for k, v in g.items()},
                    {k: jnp.asarray(v) for k, v in e.items()})
    th, te = compress_decompress({k: torch.from_numpy(v)
                                  for k, v in g.items()},
                                 {k: torch.from_numpy(v)
                                  for k, v in e.items()})
    _assert_tree_close(th, jh, 1e-6, "grads_hat")
    _assert_tree_close(te, je, 1e-6, "residuals")


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def test_smoke_train_step():
    """Twin of test_models.py::test_smoke_train_step (dense)."""
    cfg = torch_smoke(ARCH)
    from repro_torch.models import lm as tlm
    params = tlm.init_params(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    before = _clone(params)
    opt = adamw_init(params)
    step = make_train_step(cfg, peak_lr=1e-2, warmup=1)
    p2, o2, m = step(params, opt, _torch_batch(_batch(cfg, 0)))
    assert np.isfinite(float(m["loss"]))
    assert float(m["grad_norm"]) > 0
    l0, l1 = tree_leaves(before)[1], tree_leaves(p2)[1]
    assert not torch.allclose(l0, l1)
    assert int(o2.step) == 1


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_jax(compute_dtype):
    """Three steps of the port against three JAX steps from the same
    weights and batches: each step's gradients, loss, grad norm and lr,
    then every parameter and the first AdamW moment."""
    jcfg, tcfg = _cfgs(compute_dtype=compute_dtype)
    jp, tp = _weights(jcfg, tcfg)
    jo, to = jax_adamw_init(jp), adamw_init(tp)
    jstep = jax.jit(jax_train_step(jcfg, peak_lr=1e-2, warmup=2))
    tstep = make_train_step(tcfg, peak_lr=1e-2, warmup=2)
    tol = STEP_TOLS[compute_dtype]
    for i in range(3):
        b = _batch(jcfg, i)
        if compute_dtype == "float32" or i == 0:
            _, jg = _jax_loss_and_grads(jcfg, jp, b)
            _, tg = loss_and_grads(tcfg, tp, _torch_batch(b))
            _assert_scaled_close(tg, jg, tol["grads"], f"grads step {i}")
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tstep(tp, to, _torch_batch(b))
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=tol[name],
                                       err_msg=f"{name} step {i}")
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    _assert_rel_l2(tp, jp, tol["params"], "params")
    _assert_rel_l2(to.m, jo.m, 2 * tol["grads"], "m")
    assert int(to.step) == int(jo.step) == 3


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_train_step_matches_jax_ssm_and_hybrid(arch):
    """The families the card cannot train yet (no SSD backward kernel)
    train on the CPU through the plain versions, as JAX trains with
    ``use_pallas=False``: one fp32 step against JAX (the port sums the SSD
    decay exponents in fp64, the JAX package in fp32: measured 5.3e-6 on
    the gradients of mamba2-130m)."""
    jcfg, tcfg = _cfgs(arch, compute_dtype="float32")
    jp, tp = _weights(jcfg, tcfg)
    b = _batch(jcfg, 0)
    _assert_scaled_close(loss_and_grads(tcfg, tp, _torch_batch(b))[1],
                         _jax_loss_and_grads(jcfg, jp, b)[1], 5e-5, "grads")
    jp, jo, jm = jax.jit(jax_train_step(jcfg, peak_lr=1e-2, warmup=1))(
        jp, jax_adamw_init(jp), {k: jnp.asarray(v) for k, v in b.items()})
    tp, to, tm = make_train_step(tcfg, peak_lr=1e-2, warmup=1)(
        tp, adamw_init(tp), _torch_batch(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    _assert_rel_l2(tp, jp, ONE_STEP_PARAMS, "params")


def _loss_grads(cfg, params, b):
    loss, grads = loss_and_grads(cfg, params, _torch_batch(b))
    return float(loss), tree_leaves(grads)


def test_microbatches_two_equal_one():
    """cfg.microbatches = 2 accumulates the gradient of the whole batch."""
    _, tp = _weights(*_cfgs(compute_dtype="float32"))
    tcfg = torch_smoke(ARCH).replace(compute_dtype="float32")
    b = _batch(tcfg, 0, B=4)
    l1, g1 = _loss_grads(tcfg, tp, b)
    l2, g2 = _loss_grads(tcfg.replace(microbatches=2), tp, b)
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    for a, c in zip(g1, g2):
        assert c.dtype == torch.float32
        err = (c - a).abs().max() / a.abs().max()
        assert err <= 1e-5, err


def test_microbatched_train_step_matches_jax():
    """microbatches = 2 in both packages."""
    jcfg, tcfg = _cfgs(compute_dtype="float32", microbatches=2)
    jp, tp = _weights(jcfg, tcfg)
    b = _batch(jcfg, 0, B=4)
    jp, _, jm = jax.jit(jax_train_step(jcfg, peak_lr=1e-2, warmup=1))(
        jp, jax_adamw_init(jp), {k: jnp.asarray(v) for k, v in b.items()})
    tp, _, tm = make_train_step(tcfg, peak_lr=1e-2, warmup=1)(
        tp, adamw_init(tp), _torch_batch(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _assert_rel_l2(tp, jp, ONE_STEP_PARAMS, "params")


@pytest.mark.parametrize("arch", [ARCH, "zamba2-2.7b"])
def test_remat_equals_no_remat(arch):
    """Rematerialising each layer recomputes the same values: the loss and
    every gradient are bitwise those of the run that keeps activations."""
    _, tp = _weights(*_cfgs(arch, compute_dtype="float32"))
    tcfg = torch_smoke(arch).replace(compute_dtype="float32")
    b = _batch(tcfg, 0)
    l0, g0 = _loss_grads(tcfg.replace(remat=False), tp, b)
    l1, g1 = _loss_grads(tcfg.replace(remat=True), tp, b)
    assert l0 == l1
    for a, c in zip(g0, g1):
        assert torch.equal(a, c)


def test_compressed_train_step():
    """Twin of test_substrate.py::test_train_step_with_compression_converges,
    and the first step against JAX's compressed step."""
    jcfg, tcfg = _cfgs(grad_compression=True)
    jp, tp = _weights(jcfg, tcfg)
    b0 = _batch(jcfg, 0)
    from repro.optim.compression import ef_init as jax_ef_init
    _, _, _, jm = jax.jit(jax_train_step(jcfg, peak_lr=1e-2, warmup=1))(
        jp, jax_adamw_init(jp), jax_ef_init(jp),
        {k: jnp.asarray(v) for k, v in b0.items()})
    step = make_train_step(tcfg, peak_lr=1e-2, warmup=1)
    opt, ef = adamw_init(tp), ef_init(tp)
    losses = []
    for i in range(8):
        tp, opt, ef, m = step(tp, opt, ef, _torch_batch(_batch(tcfg, i)))
        if i == 0:
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=2e-2)
        losses.append(float(m["loss"]))
    assert min(losses[1:]) < losses[0] - 0.05
    with pytest.raises(NotImplementedError):
        make_train_step(tcfg.replace(microbatches=2))(
            tp, opt, ef, _torch_batch(_batch(tcfg, 0, B=4)))


def test_train_restart_matches_uninterrupted(tmpdir):
    """Twin of test_substrate.py::test_train_restart_matches_uninterrupted:
    crash at step 8, restore from the checkpoint at 5, and the final
    params are bitwise those of the uninterrupted run."""
    cfg = torch_smoke(ARCH)
    from repro_torch.models import lm as tlm
    params0 = tlm.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    step_fn = make_train_step(cfg)

    def batch_for(i):
        return _torch_batch(_batch(cfg, 1000 + i))

    p = _clone(params0)
    o = adamw_init(p)
    for i in range(10):
        p, o, _ = step_fn(p, o, batch_for(i))
    ref = p

    p = _clone(params0)
    o = adamw_init(p)
    for i in range(8):
        if i == 5:
            save_checkpoint(tmpdir, 5, {"p": p, "o": o})
        p, o, _ = step_fn(p, o, batch_for(i))
        if i == 7:
            break  # "crash"
    st = latest_step(tmpdir)
    restored = load_checkpoint(tmpdir, st, {"p": p, "o": o})
    p, o = restored["p"], restored["o"]
    assert int(o.step) == 5
    for i in range(st, 10):
        p, o, _ = step_fn(p, o, batch_for(i))
    for a, b in zip(tree_leaves(ref), tree_leaves(p)):
        assert torch.equal(a, b)


def test_train_loop_restores_and_resumes(tmpdir):
    """TrainLoop: an injected failure after a checkpoint, then a new loop
    that restores it resumes at its step, over a ring-backed loader."""
    from repro_torch.data import RingLoader, TokenStore, \
        make_synthetic_corpus
    from repro_torch.train import InjectedFailure, TrainLoop, \
        TrainLoopConfig
    cfg = torch_smoke(ARCH)
    path = make_synthetic_corpus(os.path.join(tmpdir, "tok.bin"), 20_000,
                                 cfg.vocab_size)
    lc = TrainLoopConfig(total_steps=5, ckpt_every=2,
                         ckpt_dir=os.path.join(tmpdir, "ckpt"), log_every=1,
                         fail_at_step=3)
    loop = TrainLoop(cfg, lc, RingLoader(TokenStore(path), batch=2, seq=32),
                     device="cpu")
    with pytest.raises(InjectedFailure):
        loop.run()
    assert latest_step(lc.ckpt_dir) == 2 and len(loop.metrics_log) == 3
    lc.fail_at_step = None
    again = TrainLoop(cfg, lc, RingLoader(TokenStore(path), batch=2, seq=32),
                      device="cpu", seed=1)
    assert again.restore() == 2 and int(again.opt_state.step) == 3
    for a, b in zip(tree_leaves(again.params), tree_leaves(loop.params)):
        assert torch.equal(a, b)
    last = again.run()
    assert last["step"] == 4 and np.isfinite(last["loss"])
    assert int(again.opt_state.step) == 6
