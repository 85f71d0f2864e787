"""The port's copies of the paper's storage and network engines
(``core/perfmodel``, ``storage/``, ``wal/``, ``lsm/``, ``replication/``,
``shuffle/``) held against the JAX package's on the simulated clock: the
same seeded workload through ``repro.X`` and ``repro_torch.X`` gives equal
result dicts and byte-equal crash images, and a crash image written by
either package recovers under the other's ``recover`` / ``recover_lsm`` to
the same key -> value map, one that holds every acknowledged commit.
``test_torch_ckpt.py`` holds the copies to the text of the originals."""

import importlib
import os
import pathlib
import struct
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKGS = ("repro", "repro_torch")
MiB = 1 << 20
ENTERPRISE = dict(plp=True, fsync_lat=30e-6)
RUNGS = [c.name for c in importlib.import_module(
    "repro.storage.engine").EngineConfig.ladder()]


def _mod(pkg, rel):
    return importlib.import_module(f"{pkg}.{rel}")


def _spec(pkg):
    return _mod(pkg, "core").NVMeSpec(**ENTERPRISE)


def _ladder(pkg):
    return {c.name: c for c in _mod(pkg, "storage.engine").EngineConfig
            .ladder()}


def _stamp(eng, txn_id, key):
    """A value naming its writer: (txn id, key), zero-padded."""
    val = struct.pack("<qq", txn_id, key)
    return val + bytes(eng.cfg.value_size - len(val))


# ---------------------------------------------------------------------------
# (a) the Fig. 5 ladder (and the rungs built on it) on YCSB updates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rung", RUNGS)
def test_ladder_rung_equals_jax(rung):
    res = {}
    for pkg in PKGS:
        cfg = replace(_ladder(pkg)[rung], pool_frames=512)
        eng = _mod(pkg, "storage.engine").StorageEngine(cfg,
                                                        n_tuples=20_000)
        ycsb = _mod(pkg, "storage.workloads").ycsb_update_txn
        res[pkg] = eng.run_fibers(lambda rng, e=eng: ycsb(e, rng), 200)
    a, b = res.values()
    assert a["txns"] == 200 and a["faults"] > 0
    for k in ("tps", "faults", "hits", "enters", "batch_eff",
              "worker_fallbacks"):
        assert a[k] == b[k], k
    assert a == b


# ---------------------------------------------------------------------------
# (b) durability: crash images and recovery across the two packages
# ---------------------------------------------------------------------------

def _writers(eng, n_fibers, keys_per_fiber, abort_every=0):
    """Each fiber owns a disjoint key slice and writes 1-3 values naming
    their txn; every ``abort_every``-th txn aborts (0: none). The shape of
    ``test_wal.py``'s crash workload. Returns the fibers, the acked txn
    ids, the last acked value of each key and every txn's staged writes."""
    acked, expect, staged = [], {}, {}

    def fiber(fid):
        rng = np.random.default_rng(1000 + fid)
        lo = fid * keys_per_fiber
        i = 0
        while True:
            i += 1
            t = eng.begin()
            writes = []
            for _ in range(int(rng.integers(1, 4))):
                key = lo + int(rng.integers(0, keys_per_fiber))
                val = _stamp(eng, t.id, key)
                yield from t.update(key, val)
                writes.append((key, val))
            staged[t.id] = writes
            if abort_every and i % abort_every == 0:
                yield from eng.abort(t)
                continue
            yield from eng.commit(t)
            acked.append(t.id)
            for key, val in writes:
                expect[key] = val

    return [fiber(f) for f in range(n_fibers)], acked, expect, staged


def _assert_holds_acked(got, expect, staged, winners):
    """Every acknowledged write reads back, or was overwritten by a later
    winner whose COMMIT went durable before its ack resumed."""
    for key, val in expect.items():
        v = got[key]
        assert v is not None, f"acked write to key {key} lost"
        if v == val:
            continue
        w = struct.unpack_from("<q", v)[0]
        assert w in winners and w > struct.unpack_from("<q", val)[0] and \
            (key, v) in staged.get(w, []), f"acked write to key {key} lost"


DURABLE = {"wal": "+WAL", "group": "+GroupCommit",
           "passthru-flush": "+PassthruFlush"}


@pytest.mark.parametrize("steps", [1_500, 5_000, 15_000])
@pytest.mark.parametrize("durability", list(DURABLE))
def test_crash_images_equal_and_recover_across_packages(durability, steps):
    n_fibers, n_tuples = 32, 8_000
    runs = {}
    for pkg in PKGS:
        cfg = replace(_ladder(pkg)[DURABLE[durability]], n_fibers=n_fibers,
                      pool_frames=128, ckpt_every=40)
        eng = _mod(pkg, "storage.engine").StorageEngine(cfg,
                                                        n_tuples=n_tuples)
        fibers, acked, expect, staged = _writers(
            eng, n_fibers, n_tuples // n_fibers, abort_every=5)
        for f in fibers:
            eng.sched.spawn(f)
        budget = {"left": steps}

        def out_of_budget(b=budget):
            b["left"] -= 1
            return b["left"] <= 0
        eng.sched.run(until=out_of_budget)
        runs[pkg] = (eng.crash_images(), acked, expect, staged, eng.tl.now)
    (img, acked, expect, staged, now), other = runs.values()
    assert img == other[0]                   # byte-equal data and log
    assert (acked, expect, now) == other[1:3] + (other[4],)
    assert acked, "nothing acked before the crash"
    maps = {}
    for writer in PKGS:                      # whose images ...
        for reader in PKGS:                  # ... whose recover
            rec, rep = _mod(reader, "wal").recover(*runs[writer][0],
                                                   pool_frames=512)
            assert set(acked) <= rep.winners
            maps[writer, reader] = (rec.get_many(range(n_tuples)),
                                    rep.winners)
    first = maps["repro", "repro"]
    assert all(m == first for m in maps.values())
    _assert_holds_acked(first[0], expect, staged, first[1])


# ---------------------------------------------------------------------------
# (c) the LSM engine: flush and compaction, a crash during compaction
# ---------------------------------------------------------------------------

def _lsm_engine(pkg, n_tuples=4_000):
    cfg = _mod(pkg, "storage.engine").EngineConfig.lsm(n_fibers=32,
                                                        pool_frames=256)
    return _mod(pkg, "storage.engine").make_engine(
        cfg, n_tuples=n_tuples, seed=0, spec=_spec(pkg))


def _lsm_update(e, rng):
    key = int(rng.integers(0, e.n_tuples))
    e.charge(1e-6)
    t = e.begin()
    yield from t.update(key, struct.pack("<q", key) +
                        bytes(e.cfg.value_size - 8))
    yield from e.commit(t)


def test_lsm_flush_and_compaction_equal_jax():
    res = {}
    for pkg in PKGS:
        e = _lsm_engine(pkg)
        res[pkg] = e.run_fibers(lambda rng, e=e: _lsm_update(e, rng), 3_000)
    a, b = res.values()
    assert a["flushes"] > 0 and a["compactions"] > 0
    assert a == b


@pytest.mark.parametrize("stop_ms", [3.0, 6.0, 12.0])
def test_lsm_crash_during_compaction_recovers_across_packages(stop_ms):
    runs = {}
    for pkg in PKGS:
        e = _lsm_engine(pkg)
        fibers, acked, expect, staged = _writers(e, 16, 200)
        workers = [e.sched.spawn(f) for f in fibers]
        e.spawn_service_fibers(workers, done=lambda: False)
        e.sched.run(until=lambda e=e: (e.compactor.jobs >= 1 and
                                       e.tl.now >= stop_ms * 1e-3))
        assert e.flushes > 0 and e.compactor.jobs >= 1
        runs[pkg] = (e.crash_images(), acked, expect, staged)
    (img, acked, expect, staged), other = runs.values()
    assert img == other[0]
    assert (acked, expect) == other[1:3]
    assert acked
    maps = []
    for writer in PKGS:
        data, log = runs[writer][0]
        for reader in PKGS:
            rec = _mod(reader, "lsm").recover_lsm(log, data)
            maps.append({k: rec.get(k) for k in range(e.n_tuples)})
    assert all(m == maps[0] for m in maps)
    winners = {struct.unpack_from("<q", v)[0] for v in maps[0].values()
               if v is not None}
    _assert_holds_acked(maps[0], expect, staged, winners)


# ---------------------------------------------------------------------------
# (d) replication: the async, semisync and sync rungs
# ---------------------------------------------------------------------------

MODE_RUNG = {"async": "+AsyncRepl", "semisync": "+SemiSync",
             "sync": "+SyncRepl"}


def _cluster(pkg, mode, n_fibers=16, n_tuples=4_000, frames=256):
    cfg = replace(_ladder(pkg)[MODE_RUNG[mode]], n_fibers=n_fibers,
                  pool_frames=frames)
    return _mod(pkg, "replication").ReplicatedCluster(
        cfg, n_tuples=n_tuples, spec=_spec(pkg))


@pytest.mark.parametrize("mode", list(MODE_RUNG))
def test_replicated_commit_latency_equals_jax(mode):
    res = {}
    for pkg in PKGS:
        cl = _cluster(pkg, mode, n_fibers=32, n_tuples=8_000, frames=512)
        ycsb = _mod(pkg, "storage.workloads").ycsb_update_txn
        res[pkg] = cl.run(lambda rng, e=cl.primary: ycsb(e, rng), 128)
    a, b = res.values()
    assert a["standby_commits"] == a["commits"] == 128
    assert a["commit_wait_us"] == b["commit_wait_us"]
    assert a == b


@pytest.mark.parametrize("mode", list(MODE_RUNG))
def test_failover_images_equal_and_promote_across_packages(mode):
    runs = {}
    for pkg in PKGS:
        cl = _cluster(pkg, mode)
        fibers, acked, expect, staged = _writers(cl.primary, 16,
                                                 4_000 // 16)
        cl.crash_run(fibers, steps=4_000)
        runs[pkg] = (cl.standby.crash_images(), cl.primary.crash_images(),
                     acked, expect, staged)
    (simg, pimg, acked, expect, staged), other = runs.values()
    assert (simg, pimg) == other[:2]         # standby's and primary's
    assert (acked, expect) == other[2:4]
    assert acked
    maps = []
    for writer in PKGS:
        data, log = runs[writer][0]
        for reader in PKGS:                  # promote from durable state
            rec, rep = _mod(reader, "wal").recover(data, log,
                                                   pool_frames=512,
                                                   full_redo=True)
            maps.append((rec.get_many(range(4_000)), rep.winners))
    assert all(m == maps[0] for m in maps)
    got, winners = maps[0]
    if mode != "async":                      # no acked txn may be lost
        assert set(acked) <= winners
        _assert_holds_acked(got, expect, staged, winners)


def test_sync_standby_equals_the_primary():
    """After a quiesced +SyncRepl run, the standby's log is the primary's
    byte for byte and its promoted map is the primary's recovered one, in
    both packages and across them."""
    maps = []
    for pkg in PKGS:
        cl = _cluster(pkg, "sync")
        ycsb = _mod(pkg, "storage.workloads").ycsb_update_txn
        cl.run(lambda rng, e=cl.primary: ycsb(e, rng), 120)
        p, s = cl.primary.wal, cl.standby.wal
        assert p.durable_lsn == s.durable_lsn == cl.sender.shipped
        assert bytes(p.buf[:p.durable_lsn]) == bytes(s.buf[:s.durable_lsn])
        assert cl.standby.last_writer == cl.primary.last_writer
        rec, _ = cl.standby.promote(pool_frames=512)
        prim, _ = _mod(pkg, "wal").recover(*cl.primary.crash_images(),
                                           pool_frames=512)
        maps += [rec.get_many(range(4_000)), prim.get_many(range(4_000))]
    assert all(m == maps[0] for m in maps)


# ---------------------------------------------------------------------------
# (e) the shuffle: the ring-driven engine and the closed-form oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tuple_size", [512, 4096])
@pytest.mark.parametrize("zc", [False, True])
@pytest.mark.parametrize("iface", ["uring", "epoll"])
def test_shuffle_equals_jax(iface, zc, tuple_size):
    res = {}
    for pkg in PKGS:
        sh = _mod(pkg, "shuffle")
        cfg = sh.ShuffleConfig(n_nodes=3, n_workers=8, tuple_size=tuple_size,
                               total_bytes_per_node=4 * MiB, iface=iface,
                               zc_send=zc, zc_recv=zc)
        res[pkg] = (sh.ShuffleSim(cfg).run(), sh.ShuffleEngine(cfg).run())
    (sim, eng), other = res.values()
    assert eng["egress_gib_per_node"] > 0
    assert sim == other[0] and eng == other[1]


# ---------------------------------------------------------------------------
# (f) the analytic models (paper §3.2-3.3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.1, 0.7, 2.0])
def test_analytic_models_equal_jax(rate):
    out = []
    for pkg in PKGS:
        pm = _mod(pkg, "core.perfmodel")
        out.append((
            pm.LatencyModel(page_fault_rate=rate).tx_per_s(),
            pm.LatencyModel(page_fault_rate=rate,
                            batch_evict=True).tx_per_s(),
            pm.CycleModel(pm.PAPER_C_TX, pm.PAPER_C_READ_BATCH +
                          pm.PAPER_C_WRITE_BATCH, rate).tx_per_s(),
            pm.CycleModel(pm.PAPER_C_TX, pm.PAPER_C_READ_SINGLE,
                          rate).tx_per_s()))
    assert out[0] == out[1]
    assert all(x > 0 for x in out[0])


# ---------------------------------------------------------------------------
# the engines stand alone
# ---------------------------------------------------------------------------

def test_engines_run_with_jax_and_repro_unimportable():
    """One storage rung, one crash recovery and one shuffle through the
    port's five new packages while any ``import jax`` or ``import repro``
    raises."""
    code = """
import struct, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from dataclasses import replace
import repro_torch.lsm, repro_torch.replication
from repro_torch.core.perfmodel import LatencyModel
from repro_torch.shuffle import ShuffleConfig, ShuffleSim, ShuffleEngine
from repro_torch.storage.engine import EngineConfig, StorageEngine
from repro_torch.storage.workloads import ycsb_update_txn
from repro_torch.wal import recover
rungs = {c.name: c for c in EngineConfig.ladder()}
eng = StorageEngine(replace(rungs["+SQPoll"], pool_frames=256), n_tuples=4000)
assert eng.run_fibers(lambda rng: ycsb_update_txn(eng, rng), 100)["tps"] > 0
eng = StorageEngine(replace(rungs["+GroupCommit"], n_fibers=8,
                            pool_frames=128), n_tuples=4000)
acked = {}
def txn(rng):
    t = eng.begin()
    key = t.id % 4000                      # one txn a key
    val = struct.pack("<q", t.id) + bytes(eng.cfg.value_size - 8)
    yield from t.update(key, val)
    yield from eng.commit(t)
    acked[key] = val
eng.run_fibers(txn, 200)
rec, rep = recover(*eng.crash_images(), pool_frames=256)
assert rec.get_many(sorted(acked)) == acked
cfg = ShuffleConfig(n_nodes=3, n_workers=4, total_bytes_per_node=1 << 22)
assert ShuffleEngine(cfg).run()["egress_gib_per_node"] > 0
assert ShuffleSim(cfg).run()["egress_gib_per_node"] > 0
assert LatencyModel(page_fault_rate=0.7).tx_per_s() > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("repro", "jax", "jaxlib")
             and sys.modules[m] is not None)
assert not bad, bad
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "OK", res.stderr
