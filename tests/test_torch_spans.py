"""The card's spans and counters (``repro_torch.observe.spans``) on the
CPU: the recorder's records and counters, the spans of the serving and
training loops and of the MoE layer, and that recording changes no token
and no loss. The CUDA marks are held on the card (marker ``gpu``)."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import MoEConfig, ModelConfig
from repro_torch.data import RingLoader, TokenStore, make_synthetic_corpus
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.observe import spans
from repro_torch.serve import ServeLoop
from repro_torch.train import TrainLoop, TrainLoopConfig
from repro_torch.tree import tree_leaves

ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    yield
    spans.disable()


def _serve_loop(cfg=None):
    cfg = cfg or get_smoke_config(ARCH)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return ServeLoop(cfg, params, max_len=32, device="cpu")


def _prompt(cfg, B=2, S=12, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S),
                                                dtype=np.int32)


def _train_loop(tmp_path, steps=2):
    cfg = get_smoke_config(ARCH)
    path = make_synthetic_corpus(str(tmp_path / "tok.bin"), 20_000,
                                 cfg.vocab_size)
    lc = TrainLoopConfig(total_steps=steps, ckpt_every=1 << 30,
                         ckpt_dir=str(tmp_path / "ckpt"), log_every=1)
    return TrainLoop(cfg, lc, RingLoader(TokenStore(path), batch=2, seq=32,
                                         seed=3), device="cpu", seed=0)


def _children(records, i, name):
    return [r for r in records if r.parent == i and r.name == name]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_spans_nest_and_take_empties_the_recorder():
    cpu = torch.device("cpu")
    spans.enable()
    with spans.span("serve_generate"):
        with spans.span("serve_prefill", mark=cpu):
            pass
        with spans.span("serve_decode", mark=cpu):
            with spans.span("moe_router"):
                pass
    recs, counters = spans.take()
    assert [(r.name, r.parent) for r in recs] == [
        ("serve_generate", None), ("serve_prefill", 0),
        ("serve_decode", 0), ("moe_router", 2)]
    assert counters == {}
    assert recs[0].mark0_ms is None and recs[3].mark1_ms is None
    for r in recs:
        assert r.t0_ns <= r.t1_ns
    assert 0 <= recs[1].mark0_ms <= recs[1].mark1_ms <= recs[2].mark0_ms \
        <= recs[2].mark1_ms
    assert spans.on() and spans.take() == ([], {})
    spans.disable()
    with spans.span("train_step"):
        pass
    assert not spans.on() and spans.take() == ([], {})


def test_counters_add_tensors_and_numbers_across_modes():
    spans.enable()
    with torch.inference_mode():
        spans.count("c", torch.tensor([True, False, True]))
        spans.count("n", 5)
    spans.count("c", torch.ones(4, dtype=torch.bool))
    spans.count("n", 2)
    spans.count("f", torch.tensor([0.5, 0.25]))
    _, counters = spans.take()
    assert counters == {"c": 6, "n": 7, "f": 0.75}


def test_a_span_closes_on_an_exception():
    spans.enable()
    with pytest.raises(ValueError):
        with spans.span("train_step"):
            raise ValueError
    with spans.span("train_step"):
        pass
    recs, _ = spans.take()
    assert [r.parent for r in recs] == [None, None]


# ---------------------------------------------------------------------------
# the loops' spans
# ---------------------------------------------------------------------------

def test_recorder_off_leaves_no_records_and_never_counts(monkeypatch,
                                                         tmp_path):
    def boom(*a, **k):
        raise AssertionError("counted with the recorder off")
    monkeypatch.setattr(spans, "count", boom)
    loop = _serve_loop()
    loop.generate(_prompt(loop.cfg), 3)
    _train_loop(tmp_path).run()
    assert not spans.on() and spans.take() == ([], {})


def test_a_generate_gives_a_prefill_and_its_decode_steps():
    loop = _serve_loop()
    spans.enable()
    n_new = 5
    for seed in (1, 2):
        loop.generate(_prompt(loop.cfg, seed=seed), n_new)
    recs, counters = spans.take()
    roots = [i for i, r in enumerate(recs) if r.name == "serve_generate"]
    assert len(roots) == 2
    for i in roots:
        assert recs[i].parent is None
        pre = _children(recs, i, "serve_prefill")
        dec = _children(recs, i, "serve_decode")
        assert len(pre) == 1 and len(dec) == n_new - 1
        marks = [pre[0].mark0_ms, pre[0].mark1_ms] + \
            [m for d in dec for m in (d.mark0_ms, d.mark1_ms)]
        assert marks == sorted(marks)
    # every other span is a stage of the MoE layer, inside a step
    for r in recs:
        if r.name in ("serve_generate", "serve_prefill", "serve_decode"):
            continue
        assert r.name.startswith("moe_")
        while recs[r.parent].name.startswith("moe_"):
            r = recs[r.parent]
        assert recs[r.parent].name in ("serve_prefill", "serve_decode")
    assert counters["moe_slots"] >= counters["moe_kept_slots"] > 0


def test_a_train_step_gives_its_data_wait_and_update(tmp_path):
    loop = _train_loop(tmp_path, steps=3)
    spans.enable()
    loop.run()
    recs, counters = spans.take()
    roots = [i for i, r in enumerate(recs) if r.name == "train_step"]
    assert len(roots) == 3 and all(recs[i].parent is None for i in roots)
    for i in roots:
        data = _children(recs, i, "train_data")
        opt = _children(recs, i, "optim_adamw")
        assert len(data) == 1 and len(opt) == 1
        assert data[0].t1_ns <= opt[0].t0_ns
        assert recs[i].t0_ns <= data[0].t0_ns and opt[0].t1_ns <= \
            recs[i].t1_ns
    assert counters["moe_slots"] >= counters["moe_kept_slots"] > 0


# ---------------------------------------------------------------------------
# the MoE layer's counters
# ---------------------------------------------------------------------------

def _crowded():
    cfg = ModelConfig(arch_id="t", family="moe", n_layers=1, d_model=8,
                      n_heads=2, n_kv_heads=2, d_ff=8, vocab_size=16,
                      moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=4))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 1, 200, 8, generator=g)
    router = torch.randn(8, 16, generator=g)
    router[:, 0] += 2.0                 # crowd expert 0 past its capacity
    return cfg, x, router


def test_kept_slots_equal_a_hand_count_of_the_dispatch():
    cfg, x, router = _crowded()
    _, _, keep, _, _, _ = moe._dispatch(cfg, router, x, torch.float32)
    spans.enable()
    _, _, keep_on, _, _, _ = moe._dispatch(cfg, router, x, torch.float32)
    _, counters = spans.take()
    assert torch.equal(keep, keep_on)
    # the hand count: each (token, k) slot whose place in its expert's
    # queue is under the capacity
    C = moe.capacity(cfg, 200)
    ids = moe._top_k(torch.softmax(x.float() @ router, -1), 2)[1]
    kept = 0
    for b in range(2):
        seen = [0] * 16
        for e in ids[b, 0].reshape(-1).tolist():
            kept += seen[e] < C
            seen[e] += 1
    assert counters["moe_kept_slots"] == kept == int(keep.sum())
    assert counters["moe_slots"] == 2 * 200 * 2 > kept


def test_a_layer_counts_each_dispatch_it_runs():
    cfg = get_smoke_config("mixtral-8x22b")        # experts split in 4
    p = {k: v[0] for k, v in lm.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")["layers"]
        ["moe"].items()}
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    spans.enable()
    moe.moe_ffn(cfg, p, x, torch.float32)
    moe.moe_ffn(cfg, p, x, torch.float32)
    _, counters = spans.take()
    Ke = cfg.moe.top_k * moe.expert_split(cfg)
    assert counters["moe_slots"] == 2 * 2 * 24 * Ke


# ---------------------------------------------------------------------------
# recording changes nothing the program computes
# ---------------------------------------------------------------------------

def test_tokens_and_losses_are_the_same_with_the_recorder_on(tmp_path):
    loop = _serve_loop()
    prompt = _prompt(loop.cfg)
    off = loop.generate(prompt, 6)
    spans.enable()
    on = loop.generate(prompt, 6)
    spans.disable()
    assert torch.equal(off, on)

    runs = []
    for rec in (False, True):
        if rec:
            spans.enable()
        (tmp_path / str(rec)).mkdir()
        loop = _train_loop(tmp_path / str(rec), steps=3)
        loop.run()
        spans.disable()
        runs.append(([m["loss"] for m in loop.metrics_log],
                     tree_leaves(loop.params)))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_marks_time_the_device():
    if not torch.cuda.is_available():
        pytest.skip("the marks are CUDA events: needs a card")
    dev = torch.device("cuda")
    a = torch.randn(4096, 4096, device=dev)
    a = a @ a.T / 64                     # cuBLAS set up before the span
    torch.cuda.synchronize()
    spans.enable()
    with spans.span("serve_decode", mark=dev):
        for _ in range(20):
            a = a @ a.T / 64
    recs, _ = spans.take()
    dev_ms = recs[0].mark1_ms - recs[0].mark0_ms
    host_ms = (recs[0].t1_ns - recs[0].t0_ns) * 1e-6
    # the host only queues the products; the marks time their run
    assert dev_ms > 5 * host_ms
