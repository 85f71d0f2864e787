"""The port's KV pager (``repro_torch.serve.kv_paging``) on its copy of the
ring runtime, on the CPU: twins of ``tests/test_serve_paging.py`` and of
``test_substrate.py::test_kv_pager_spill_and_restore``, and two checks
across the packages: each serving-ladder rung gives the JAX package's
result dict key for key and value for value (the same code on a virtual
clock from the same seed), and a page packed by either package unpacks to
the same bits in the other.

The numbers the ladder reports (``tok_s``, ``p50_us``, ``sim_seconds``)
are the simulator's virtual clock, not a device's."""

from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as jax_backends
from repro.kernels.paged_attn.ops import paged_attention as jax_paged
from repro.serve.kv_paging import KVPager as JaxKVPager
from repro.serve.kv_paging import PagerConfig as JaxPagerConfig
from repro_torch.core import backends
from repro_torch.kernels.paged_attn.ops import paged_attention
from repro_torch.kernels.paged_attn.ref import paged_attention_ref
from repro_torch.observe import advisor
from repro_torch.serve import KVPager, PagerConfig

#: tests/test_serve_paging.py's guaranteed-miss ladder: the per-sequence
#: walk (64 blocks) exceeds the 96-frame pool, so every rung faults on
#: every block; n_seqs * k = 64 <= ~0.75 * 96 keeps prefetch within frames
MINI = dict(n_hbm_pages=96, host_pages=16, nvme_pages=1024,
            page_tokens=8, head_dim=16)


def _ladder(Config, Pager):
    res = {}
    for c in Config.ladder(prefetch_k=8, **MINI):
        p = Pager(c)
        p.prefill(n_seqs=8, n_blocks=64, seed=1)
        res[c.name] = p.run_decode(n_tokens=2)
    return res


@pytest.fixture(scope="module")
def ladder_results():
    return _ladder(PagerConfig, KVPager)


def _bf16_page(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(torch.bfloat16)


def test_named_device_slots():
    """The serving tier's spill slots are the registry constants the JAX
    package's storage engine shares, distinct from its data and log slots;
    the host spill tier is the fast one."""
    for name in ("DATA_FD", "LOG_FD", "KV_HOST_FD", "KV_NVME_FD"):
        assert getattr(backends, name) == getattr(jax_backends, name)
    slots = {backends.DATA_FD, backends.LOG_FD,
             backends.KV_HOST_FD, backends.KV_NVME_FD}
    assert len(slots) == 4
    assert backends.host_dram_spec().read_lat \
        < backends.kv_nvme_spec().read_lat
    pager = KVPager(PagerConfig(n_hbm_pages=4, page_tokens=4,
                                kv_heads=2, head_dim=8))
    assert set(pager.ring._devices) == {backends.KV_HOST_FD,
                                        backends.KV_NVME_FD}


def test_thrash_refault_byte_identical():
    """Random put/read interleave over a 4-frame pool vs a model dict:
    every refault returns exactly the bytes last written, across both
    the host spill tier and the NVMe cold tier."""
    cfg = PagerConfig(n_hbm_pages=4, page_tokens=4, kv_heads=2,
                      head_dim=8, host_pages=16, nvme_pages=64)
    pager = KVPager(cfg)
    rng = np.random.default_rng(0)
    keys = [(s, b) for s in range(3) for b in range(14)]   # 42 > host
    model = {}
    for _ in range(300):
        key = keys[int(rng.integers(len(keys)))]
        if key not in model or rng.random() < 0.5:
            data = rng.bytes(cfg.page_bytes)
            model[key] = data
            pager.run_sync(pager.put_page(key, data))
        else:
            assert pager.read_page_sync(key) == model[key]
    assert pager.pool.writebacks > 0
    assert pager.spilled_pages() > 0
    assert pager.cold_reads > 0 and pager.host_reads > 0
    for key, data in model.items():
        assert pager.read_page_sync(key) == data


def test_no_lost_dirty_under_concurrent_prefetch_and_eviction():
    """Three writer fibers mutate their own sequences while prefetch
    fibers pull pages in batches and the cleaner evicts under pressure:
    no dirty page is lost or torn."""
    cfg = PagerConfig(name="+Prefetch(4)", batch=True, fixed_bufs=True,
                      prefetch_k=4, n_hbm_pages=12, page_tokens=4,
                      kv_heads=2, head_dim=8, host_pages=8,
                      nvme_pages=128, evict_batch=4)
    pager = KVPager(cfg)
    rng = np.random.default_rng(1)
    model = {}
    for s in range(3):
        for b in range(12):
            data = rng.bytes(cfg.page_bytes)
            model[(s, b)] = data
            pager.run_sync(pager.put_page((s, b), data))
    done = {"n": 0}

    def writer(s, seed):
        r = np.random.default_rng(seed)
        for _ in range(60):
            b = int(r.integers(12))
            if r.random() < 0.5:
                data = r.bytes(cfg.page_bytes)
                model[(s, b)] = data
                yield from pager.put_page((s, b), data)
            else:
                got = yield from pager.read_page((s, b))
                assert bytes(got) == model[(s, b)]
        done["n"] += 1

    def prefetcher(seed):
        r = np.random.default_rng(seed)
        while done["n"] < 3:
            s, b = int(r.integers(3)), int(r.integers(12))
            pids = [pager.key_pid[(s, (b + j) % 12)] for j in range(4)]
            yield from pager.pool.prefetch_many(pids)
            yield None

    pager.spawn_service_fibers(None, lambda: done["n"] >= 3)
    for s in range(3):
        pager.sched.spawn(writer(s, 10 + s), name=f"writer{s}")
    for i in range(2):
        pager.sched.spawn(prefetcher(20 + i), name=f"pf{i}")
    pager.sched.run()
    assert done["n"] == 3
    assert pager.pool.writebacks > 0
    for key, data in model.items():
        assert pager.read_page_sync(key) == data


def test_paged_attention_equivalence_under_thrash():
    """Forced thrash (junk pages evict the real ones to the spill tiers),
    then refault and pin: the paged op over the pager's pools through a
    table that is not the identity gives the bits of the same op over
    the pages laid out densely (on the CPU its plain version; the card's
    kernel is held to the same in tests/test_torch_gpu.py and
    chip_smoke.py), and the JAX Pallas kernel (interpret mode) on the
    same bytes agrees to 2e-5, as in tests/test_serve_paging.py."""
    cfg = PagerConfig(n_hbm_pages=10, page_tokens=8, kv_heads=2,
                      head_dim=16, host_pages=16, nvme_pages=64)
    pager = KVPager(cfg)
    rng = np.random.default_rng(3)
    B, H, nblk = 2, 4, 4                       # GQA: 4 q heads / 2 kv
    pages = {}
    for s in range(B):
        for b in range(nblk):
            kp, vp = _bf16_page(rng, (8, 2, 16)), _bf16_page(rng, (8, 2, 16))
            pages[(s, b)] = (kp, vp)
            pager.put_page_sync((s, b), kp, vp)
    for j in range(24):                        # junk evicts everything
        junk = _bf16_page(rng, (8, 2, 16))
        pager.put_page_sync((9, j), junk, junk)
    assert pager.pool.writebacks > 0           # the thrash was real

    slots = {k: pager.fix_page_sync(k) for k in pages}   # refault + pin
    k_pool, v_pool = pager.device_pools(device="cpu")
    assert k_pool.dtype == torch.bfloat16 and k_pool.shape == (10, 8, 2, 16)
    table = torch.tensor([[slots[(s, b)] for b in range(nblk)]
                          for s in range(B)], dtype=torch.int32)
    ident = torch.arange(B * nblk, dtype=torch.int32).reshape(B, nblk)
    assert not torch.equal(table, ident)
    lengths = torch.full((B,), nblk * 8, dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((B, H, 16)).astype(np.float32))
    out = paged_attention(q, k_pool.float(), v_pool.float(), table, lengths)

    kd = torch.stack([pages[(s, b)][0] for s in range(B)
                      for b in range(nblk)])
    vd = torch.stack([pages[(s, b)][1] for s in range(B)
                      for b in range(nblk)])
    out_d = paged_attention(q, kd.float(), vd.float(), ident, lengths)
    assert torch.equal(out, out_d)
    assert torch.equal(paged_attention(q.to(torch.bfloat16), k_pool, v_pool,
                                       table, lengths),
                       paged_attention(q.to(torch.bfloat16), kd, vd, ident,
                                       lengths))

    def j(t):
        return jnp.asarray(t.float().numpy())
    out_j = jax_paged(j(q), j(k_pool), j(v_pool), jnp.asarray(table.numpy()),
                      jnp.asarray(lengths.numpy()), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=2e-5,
                               atol=2e-5)
    ref = paged_attention_ref(q, k_pool.float(), v_pool.float(), table,
                              lengths)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)
    for idx in slots.values():
        pager.pool.unfix(idx)


def test_serving_ladder_monotone_and_prefetch_2x(ladder_results):
    names = list(ladder_results)
    assert names == ["sync", "+Batch", "+RegBufs", "+Prefetch(8)",
                     "+PassthruRead"]
    tok = [ladder_results[n]["tok_s"] for n in names]
    for a, b, n in zip(tok, tok[1:], names[1:]):
        assert b >= 0.95 * a, f"{n}: {b:.0f} < 0.95 * {a:.0f}"
    assert ladder_results["+Prefetch(8)"]["tok_s"] \
        >= 2.0 * ladder_results["sync"]["tok_s"]
    assert ladder_results["+PassthruRead"]["tok_s"] == max(tok)
    assert ladder_results["+Prefetch(8)"]["demand_faults"] \
        < 0.5 * ladder_results["sync"]["demand_faults"]
    assert ladder_results["+Prefetch(8)"]["prefetch_reads"] > 0
    assert ladder_results["+PassthruRead"]["passthru_cmds"] > 0
    assert all(ladder_results[n]["passthru_cmds"] == 0
               for n in names[:-1])


def test_ladder_results_equal_the_jax_packages(ladder_results):
    """The same pager code on the same virtual clock from the same seed:
    every rung's result dict equals the JAX package's, key for key and
    value for value (a difference is a fault of the copy)."""
    want = _ladder(JaxPagerConfig, JaxKVPager)
    assert list(ladder_results) == list(want)
    for name, res in ladder_results.items():
        assert res.keys() == want[name].keys(), name
        for key, val in res.items():
            assert val == want[name][key], (name, key, val, want[name][key])


def _rules(res):
    return {f.rule for f in
            advisor.diagnose(advisor.report_from_result(res))}


def test_advisor_host_spill_bound_rule(ladder_results):
    assert "host-spill-bound" in _rules(ladder_results["+RegBufs"])
    assert "host-spill-bound" not in _rules(ladder_results["+Prefetch(8)"])
    f = [f for f in advisor.diagnose(advisor.report_from_result(
        ladder_results["+RegBufs"])) if f.rule == "host-spill-bound"][0]
    assert f.rung == "+Prefetch(k)"
    assert f.severity == pytest.approx(
        ladder_results["+RegBufs"]["read_wait_frac"])


def test_advisor_pager_read_bounce_rule(ladder_results):
    assert "pager-read-bounce" in _rules(ladder_results["+Batch"])
    assert "pager-read-bounce" not in _rules(ladder_results["+RegBufs"])
    quiet = dict(ladder_results["+Batch"], pager_reads=0)
    assert "pager-read-bounce" not in _rules(quiet)
    assert "storage-bounce" in _rules(quiet)


def test_pager_metrics_registration():
    from repro_torch.observe import metrics as _metrics
    reg = _metrics.MetricsRegistry(interval_s=5e-5)
    _metrics.install(reg)
    try:
        c = PagerConfig.ladder(prefetch_k=4, n_hbm_pages=24,
                               host_pages=8, nvme_pages=256,
                               page_tokens=8, head_dim=16)[3]
        p = KVPager(c)
        p.prefill(n_seqs=2, n_blocks=32, seed=1)
        r = p.run_decode(n_tokens=2)
    finally:
        _metrics.uninstall()
    names = set(reg.series)
    assert {"pager/tokens", "pager/tok_s", "pager/demand_faults"} <= names
    assert any(n.startswith("pager/ring/") for n in names)
    assert any(n.startswith("pager/pool/") for n in names)
    assert reg.ticks > 0
    last = reg.series["pager/tokens"].last()
    assert last is not None and 0 < last <= r["tokens"]


def test_pager_open_loop_decode():
    """The pager rides the port's open-loop SLO harness: a decode step is
    the 'transaction', sequences are leased from a free list."""
    from repro_torch.observe import slo
    c = PagerConfig.ladder(prefetch_k=4, n_hbm_pages=24, host_pages=8,
                           nvme_pages=256, page_tokens=8,
                           head_dim=16)[4]
    p = KVPager(c)
    p.prefill(n_seqs=4, n_blocks=16, seed=1)
    free = deque(p.seqs)

    def make_txn(rng):
        def txn():
            s = free.popleft()
            try:
                yield from p.decode_step(s)
            finally:
                free.append(s)
        return txn()

    r = slo.run_open_loop(p, make_txn, rate_tps=2000, duration_s=0.05,
                          n_workers=4, queue_cap=16, seed=7)
    assert r["completed"] + r["dropped"] == r["offered"]
    assert r["completed"] > 0
    assert r["p99_us"] > 0
    assert len(free) == 4


def test_prefetch_many_batched_and_idempotent():
    cfg = PagerConfig(batch=True, n_hbm_pages=8, page_tokens=4,
                      kv_heads=2, head_dim=8, host_pages=32)
    pager = KVPager(cfg)
    rng = np.random.default_rng(2)
    for b in range(12):                        # 12 keys > 8 frames
        pager.run_sync(pager.put_page((0, b), rng.bytes(cfg.page_bytes)))
    absent = [pager.key_pid[(0, b)] for b in range(12)
              if pager.key_pid[(0, b)] not in pager.pool.table][:4]
    resident = next(p for p in pager.pool.table)
    assert len(absent) == 4
    st = pager.ring.stats
    enters0, sqes0 = st.enters, st.sqes_submitted
    n = pager.run_sync(pager.pool.prefetch_many(absent + [resident]))
    assert n == 4                              # resident pid skipped
    assert st.enters == enters0 + 1            # ONE batched submission
    assert st.sqes_submitted == sqes0 + 4
    for pid in absent:
        m = pager.pool.meta[pager.pool.table[pid]]
        assert m.pins == 0 and not m.loading and not m.dirty
    assert pager.run_sync(pager.pool.prefetch_many(absent)) == 0
    assert st.enters == enters0 + 1


def test_kv_pager_spill_and_restore():
    """Twin of test_substrate.py::test_kv_pager_spill_and_restore."""
    cfg = PagerConfig(n_hbm_pages=8, page_tokens=8, kv_heads=2, head_dim=16)
    pager = KVPager(cfg)
    rng = np.random.default_rng(0)
    ref = {}
    for blk in range(24):                      # 3x pool size
        kp, vp = _bf16_page(rng, (8, 2, 16)), _bf16_page(rng, (8, 2, 16))
        ref[blk] = (kp, vp)
        pager.put_page_sync((0, blk), kp, vp)
    assert pager.spilled_pages() > 0
    assert pager.pool.writebacks > 0
    for blk in (0, 3, 11):
        kp, vp = pager.unpack_page(pager.read_page_sync((0, blk)))
        assert kp.dtype == torch.bfloat16 and kp.shape == (8, 2, 16)
        assert torch.equal(kp, ref[blk][0]) and torch.equal(vp, ref[blk][1])


def test_pages_cross_between_the_packages_bit_for_bit():
    """fp32 K/V that need rounding to bf16: either package packs the same
    bytes (round to nearest even), and a page packed by one unpacks to the
    same bits in the other."""
    cfg = dict(n_hbm_pages=4, page_tokens=8, kv_heads=2, head_dim=16)
    tp, jp = KVPager(PagerConfig(**cfg)), JaxKVPager(JaxPagerConfig(**cfg))
    rng = np.random.default_rng(11)
    k, v = (rng.standard_normal((8, 2, 16)).astype(np.float32)
            for _ in range(2))
    k[0, 0, :4] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 1e-40]
    assert not np.array_equal(k, k.astype(jnp.bfloat16).astype(np.float32))
    t_bytes = tp.pack_page(torch.from_numpy(k), torch.from_numpy(v))
    j_bytes = jp.pack_page(jnp.asarray(k), jnp.asarray(v))
    assert t_bytes == j_bytes and len(t_bytes) == tp.page_bytes
    for data in (t_bytes, j_bytes):
        tk, tv = tp.unpack_page(data)
        jk, jv = jp.unpack_page(data)
        np.testing.assert_array_equal(tk.view(torch.int16).numpy(),
                                      np.asarray(jk).view(np.int16))
        np.testing.assert_array_equal(tv.view(torch.int16).numpy(),
                                      np.asarray(jv).view(np.int16))
    # pages packed on either side land in frames as the same pools
    tp.put_page_sync((0, 0), torch.from_numpy(k), torch.from_numpy(v))
    jp.put_page_sync((0, 0), jnp.asarray(k), jnp.asarray(v))
    for t, jx in zip(tp.device_pools(device="cpu"), jp.device_pools()):
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(jx).view(np.int16))
