"""CPU tests of ``bench/program_spans.py``: the program's spans leave the
traced run's existing readings as they were, the reductions against hand
counts, and the recorder pass over the tiny cells."""

import pathlib
from types import SimpleNamespace

import pytest

import tiny
from bench import harness, tracing
from bench import program_spans as ps
from repro_torch.observe import spans

ROOT = pathlib.Path(__file__).resolve().parents[2]

# one generate: a unit range around a prefill span (a MoE dispatch range
# and its kernel, the arg-max) and two decode spans; the program's spans
# are the host ranges below, each with a device mark
BASE_CPU = [(0, 1000, tracing.UNIT, 0, 1),
            (10, 40, "moe_dispatch", 0, 1),
            (12, 13, "cudaLaunchKernel", 1, 1),
            (90, 95, tracing.PICK, 0, 1),
            (96, 97, "cudaLaunchKernel", 2, 1),
            (300, 301, "cudaLaunchKernel", 3, 1),
            (600, 601, "cudaLaunchKernel", 4, 1),
            (650, 651, "repro_torch::paged_attention", 5, 1),
            (652, 653, "cudaLaunchKernel", 6, 1)]
BASE_DEV = [(20, 50, "scan", 1), (100, 120, "argmax", 2),
            (310, 400, "k", 3), (610, 640, "k", 4), (660, 700, "paged", 6)]
SPANS = [(5, 990, "serve_generate", 0, 1), (8, 150, "serve_prefill", 0, 1),
         (290, 500, "serve_decode", 0, 1), (590, 800, "serve_decode", 0, 1)]
MARKS = [(20, 120, "serve_prefill", 0), (310, 400, "serve_decode", 0),
         (610, 700, "serve_decode", 0), (20, 700, "serve_generate", 0)]


def _readings(d):
    return (d.busy_s, d.range_s("moe_dispatch"),
            d.range_s("moe_dispatch", "decode"),
            d.op_s("repro_torch::paged_attention"), d.decode_launches(),
            [g for _, g in d.breakdown["idle_gaps"]],
            d.breakdown["device_ops"])


def test_the_program_spans_leave_the_traced_readings_as_they_were():
    before = tracing.reduce(BASE_CPU, BASE_DEV, 1e-6)
    cpu = sorted(BASE_CPU + SPANS)
    after = tracing.reduce(cpu, ps.without_marks(cpu, BASE_DEV + MARKS),
                           1e-6)
    assert _readings(after) == _readings(before)
    assert before.decode_launches() == 4
    assert before.range_s("moe_dispatch") == pytest.approx(30e-9)
    # the marks are what ``without_marks`` takes away, nothing else
    assert ps.without_marks(cpu, BASE_DEV + MARKS) == BASE_DEV


def test_idle_under_a_span_matches_a_hand_count():
    cpu = sorted(BASE_CPU + SPANS)
    # serve_prefill 8-150: busy 20-50 and 100-120 -> idle 142 - 50
    assert ps.idle_under(cpu, BASE_DEV, "serve_prefill") == \
        pytest.approx(92e-9)
    # the decodes 290-500 (busy 310-400) and 590-800 (busy 610-640,
    # 660-700): 120 + 140
    assert ps.idle_under(cpu, BASE_DEV, "serve_decode") == \
        pytest.approx(260e-9)
    assert ps.idle_under(cpu, BASE_DEV, "train_data") is None
    # overlapping device intervals count once
    dev = [(0, 10, "a", 0), (5, 20, "b", 0), (30, 40, "c", 0)]
    cpu = [(2, 35, "train_data", 0, 1), (36, 50, "train_data", 0, 1)]
    # 2-35: busy 2-20 and 30-35; 36-50: busy 36-40
    assert ps.idle_under(cpu, dev, "train_data") == pytest.approx(20e-9)


def test_kernels_under_a_span_are_those_it_launched():
    cpu = sorted(BASE_CPU + SPANS)
    assert ps.kernel_s_under(cpu, BASE_DEV, "serve_decode") == \
        pytest.approx((90 + 30 + 40) * 1e-9)
    assert ps.kernel_s_under(cpu, BASE_DEV, "serve_prefill") == \
        pytest.approx(50e-9)
    # a kernel launched on another thread is not the span's
    other = [(a, b, n, c, 2 if n == "cudaLaunchKernel" and c == 3 else t)
             for a, b, n, c, t in cpu]
    assert ps.kernel_s_under(other, BASE_DEV, "serve_decode") == \
        pytest.approx(70e-9)
    assert ps.kernel_s_under(cpu, BASE_DEV, "optim_adamw") is None


def test_idle_splits_by_the_innermost_span():
    cpu = sorted(BASE_CPU + SPANS)
    got = ps.idle_by_span(cpu, BASE_DEV)
    # idle 0-20 (none 0-5, generate 5-8, prefill 8-10, the dispatch
    # 10-20), 50-100 and 120-150 in the prefill, 150-290 generate,
    # 290-310 and 400-500 decode, 500-590 generate, 590-610 and 640-660
    # and 700-800 decode, 800-990 generate, 990-1000 none
    want = {"(none)": 15, "serve_generate": 3 + 140 + 90 + 190,
            "serve_prefill": 2 + 50 + 30, "moe_dispatch": 10,
            "serve_decode": 20 + 100 + 20 + 20 + 100}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v * 1e-9), k
    # every idle second is counted once
    busy = tracing._union([(a, b) for a, b, _, _ in BASE_DEV])
    assert sum(got.values()) == pytest.approx((1000 - busy) * 1e-9)


def test_spans_on_two_threads_take_the_later_start():
    cpu = [(0, 100, "train_step", 0, 1), (40, 60, "moe_router", 0, 2)]
    got = ps.idle_by_span(cpu, [])
    assert got["train_step"] == pytest.approx(80e-9)
    assert got["moe_router"] == pytest.approx(20e-9)


def _rec(name, parent, m0=None, m1=None):
    return spans.Record(name, parent, 0, 1, m0, m1)


def test_recorder_readings_match_hand_counts():
    recs = [_rec("serve_generate", None),
            _rec("serve_prefill", 0, 0.0, 10.0),
            _rec("moe_router", 1),
            _rec("serve_decode", 0, 10.5, 12.0),
            _rec("serve_decode", 0, 12.5, 15.0),
            _rec("serve_generate", None),
            _rec("serve_prefill", 5, 20.0, 26.0),
            _rec("serve_decode", 5, 26.0, 30.0)]
    assert ps.decode_gaps(recs) == [[2.0, 3.0], [4.0]]
    assert ps.prefill_ms(recs) == pytest.approx(8.0)
    assert ps.dropped_slot_share({"moe_slots": 200,
                                  "moe_kept_slots": 150}) == 25.0
    assert ps.dropped_slot_share({}) is None


@pytest.fixture(scope="module")
def tb32(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    return tiny.write(root, compute="float32"), root / "tinybench"


@pytest.mark.parametrize("cell", ["mla-serve", "gqa-serve", "mla-prefill",
                                  "mla-train"])
def test_the_recorder_pass_reads_the_tiny_cells(tb32, cell):
    spec, data = tb32
    out = ps.run(spec, cell, 5, device="cpu", data_root=data)
    assert not spans.on()
    m = out["metrics"]
    assert out["recorder_cost"] > 0
    assert len(out["walls_recorded_s"]) == len(out["walls_plain_s"]) == \
        ps.ROUNDS
    if cell == "mla-train":
        # the CPU launches no kernels: the update's device time is left
        # out, the loader's wait is all host time
        assert set(m) == {"dropped_slot_share.train", "loader_wait_ms.train"}
        assert set(out["host_ms_a_step"]) == {"train_step", "train_data",
                                              "optim_adamw"}
    elif cell == "mla-prefill":
        assert set(m) == {"dropped_slot_share.prefill"}
    else:
        assert set(m) == {"decode_step_ms.decode", "prefill_ms.decode"}
        assert all(0 < r <= 1.0 for r in out["marks_over_walls"])
        assert 0 <= out["dropped_slot_share.decode"] < 100
    for k, v in m.items():
        assert isinstance(v, float) and v >= 0, k
    assert out["idle_by_span_s"]


# ---------------------------------------------------------------------------
# every program span is a range of the traced run's reduction
# ---------------------------------------------------------------------------

# a training unit (a step: the loader's copy, a MoE dispatch, the flash
# backward, the update, a kernel after it, one kernel of the update
# launched from another thread) and a serving unit (a prefill kernel, the
# arg-max, a decode step with a MoE experts range)
STEP_CPU = [(0, 480, tracing.UNIT, 0, 1),
            (5, 480, "train_step", 0, 1),
            (6, 20, "train_data", 0, 1),
            (8, 9, "cudaMemcpyAsync", 1, 1),
            (30, 60, "moe_dispatch", 0, 1),
            (32, 33, "cudaLaunchKernel", 2, 1),
            (80, 90, "repro_torch::flash_bwd", 0, 1),
            (82, 83, "cudaLaunchKernel", 3, 1),
            (300, 400, "optim_adamw", 0, 1),
            (305, 306, "cudaLaunchKernel", 4, 1),
            (340, 341, "cudaLaunchKernel", 5, 1),
            (350, 351, "cudaLaunchKernel", 6, 2),
            (450, 451, "cudaLaunchKernel", 7, 1),
            (500, 1000, tracing.UNIT, 0, 1),
            (502, 990, "serve_generate", 0, 1),
            (505, 600, "serve_prefill", 0, 1),
            (510, 511, "cudaLaunchKernel", 10, 1),
            (590, 595, tracing.PICK, 0, 1),
            (610, 700, "serve_decode", 0, 1),
            (620, 621, "cudaLaunchKernel", 8, 1),
            (660, 690, "moe_experts", 0, 1),
            (665, 666, "cudaLaunchKernel", 9, 1)]
STEP_DEV = [(10, 14, "Memcpy HtoD", 1), (40, 70, "scan", 2),
            (100, 200, "flash_bwd", 3), (310, 330, "adam_add", 4),
            (345, 380, "adam_sqrt", 5), (390, 395, "other", 6),
            (460, 470, "after", 7), (520, 560, "prefill_k", 10),
            (630, 650, "k", 8), (670, 680, "experts", 9)]


def test_the_readings_of_a_trace_with_every_span_prefix_are_pinned():
    d = tracing.reduce(STEP_CPU, STEP_DEV, 1e-6)
    # what the reduction read before it took every prefix, to the bit
    assert (d.busy_s, d.window_s) == (274 * 1e-9, 1e-6)
    assert [d.range_s("moe_dispatch"), d.range_s("moe_experts"),
            d.range_s("moe_experts", "decode"),
            d.range_s("moe_dispatch", "decode")] == \
        [30 * 1e-9, 10 * 1e-9, 10 * 1e-9, None]
    assert d.op_s("repro_torch::flash_bwd") == 100 * 1e-9
    assert d.op_s("repro_torch::flash_fwd") == 0.0
    assert d.decode_launches() == 2
    assert d.breakdown == {
        "device_ops": [[n, t * 1e-9] for n, t in [
            ("flash_bwd", 100), ("prefill_k", 40), ("adam_sqrt", 35),
            ("scan", 30), ("adam_add", 20), ("k", 20), ("after", 10),
            ("experts", 10), ("other", 5), ("Memcpy HtoD", 4)]],
        "idle_gaps": [[n, t * 1e-9] for n, t in [
            ("train_step", 110), ("serve_prefill", 70), ("optim_adamw", 65),
            ("train_step", 50), ("train_step", 30), ("train_data", 26),
            ("serve_decode", 20), ("optim_adamw", 15),
            ("optim_adamw", 10)]]}
    # the program's other spans: the kernels launched inside each, on its
    # thread (the update's kernel from thread 2 is not the span's)
    assert d.range_s("optim_adamw") == (20 + 35) * 1e-9
    assert d.range_s("train_data") == 4 * 1e-9
    assert d.range_s("train_step") == (4 + 30 + 100 + 20 + 35 + 10) * 1e-9
    assert d.range_s("serve_prefill") == 40 * 1e-9
    assert d.range_s("serve_decode") == (20 + 10) * 1e-9
    assert d.range_s("serve_decode", "decode") == (20 + 10) * 1e-9
    assert d.range_s("serve_prefill", "decode") is None
    # as the recorder pass's reduction reads them
    for name in ("optim_adamw", "train_step", "serve_decode"):
        assert d.range_s(name) == ps.kernel_s_under(STEP_CPU, STEP_DEV, name)


def test_a_span_under_a_new_prefix_is_a_range(monkeypatch):
    cpu = STEP_CPU + [(302, 330, "mla_qlora", 0, 1)]
    assert tracing.reduce(cpu, STEP_DEV, 1e-6).range_s("mla_qlora") is None
    monkeypatch.setattr(spans, "PREFIXES", spans.PREFIXES + ("mla_",))
    d = tracing.reduce(cpu, STEP_DEV, 1e-6)
    assert d.range_s("mla_qlora") == 20 * 1e-9
    assert d.busy_s == 274 * 1e-9


def test_optimizer_ms_reads_the_update_a_step():
    read = harness.reader(ROOT / "bench", "optimizer_ms.train")
    d = tracing.reduce(STEP_CPU, STEP_DEV, 1e-6)
    units = [{"steps": 4}, {"steps": 4}]
    ctx = SimpleNamespace(trace=d, kind="train", units=units)
    assert read(ctx) == 1e3 * (20 + 35) * 1e-9 / 8
    # nothing to read: no trace, a serving cell, no update in the trace
    assert read(SimpleNamespace(trace=None, kind="train",
                                units=units)) is None
    assert read(SimpleNamespace(trace=d, kind="serve", units=units)) is None
    bare = [e for e in STEP_CPU if e[2] != "optim_adamw"]
    assert read(SimpleNamespace(trace=tracing.reduce(bare, STEP_DEV, 1e-6),
                                kind="train", units=units)) is None
