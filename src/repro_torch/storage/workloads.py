"""YCSB and TPC-C-lite transaction generators (paper §3.2).

Scaled down from the paper's 10M tuples / 1 GB pool, keeping the SAME
pool:data ratio (~30%) so the ~70% page-fault probability under uniform
access carries over. The CPU cost of transaction logic is charged
explicitly with the paper's measured constant (c_tx = 8 264 cycles).

All write transactions go through the engine's ``begin``/``commit`` API
and therefore emit WAL records when the engine runs on a durability
rung (``+WAL``/``+GroupCommit``/``+PassthruFlush`` — see ``repro.wal``);
on the non-durable rungs the Txn handle passes straight through to the
B-tree and behaviour is unchanged.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.perfmodel import PAPER_C_TX

C_TX_S = PAPER_C_TX / 3.7e9          # transaction logic (in-memory part)


def ycsb_update_txn(engine, rng):
    """100% uniform single-tuple updates (the paper's YCSB config)."""
    key = int(rng.integers(0, engine.n_tuples))
    val = bytes(engine.cfg.value_size)
    engine.charge(C_TX_S)                # charge tx logic (per-core)
    t = engine.begin()
    ok = yield from t.update(key, val)
    assert ok, f"missing key {key}"
    yield from engine.commit(t)


def ycsb_read_txn(engine, rng):
    key = int(rng.integers(0, engine.n_tuples))
    engine.charge(C_TX_S)
    v = yield from engine.tree.lookup(key)
    assert v is not None


# ---------------------------------------------------------------------------
# YCSB core workloads (zipfian A/B/C/F)
# ---------------------------------------------------------------------------

class ZipfGen:
    """Gray et al. zipfian key picker over ``[0, n)``: the standard
    YCSB skew (theta 0.99), computed with the closed-form zeta
    approximation so construction is O(1) in ``n``.  Deterministic
    given (n, seed): the generator owns its RNG."""

    THETA = 0.99

    def __init__(self, n: int, rng: np.random.Generator):
        self.n = n
        self.rng = rng
        th = self.THETA
        self.zetan = self._zeta(n, th)
        self.zeta2 = self._zeta(2, th)
        self.alpha = 1.0 / (1.0 - th)
        self.eta = ((1.0 - (2.0 / n) ** (1.0 - th)) /
                    (1.0 - self.zeta2 / self.zetan))

    @staticmethod
    def _zeta(n: int, theta: float) -> float:
        # exact for small n; Euler–Maclaurin tail for large n keeps
        # construction O(1) (YCSB itself caches, we approximate)
        cut = min(n, 10_000)
        s = float(np.sum(1.0 / np.arange(1, cut + 1) ** theta))
        if n > cut:
            s += ((n ** (1.0 - theta) - cut ** (1.0 - theta)) /
                  (1.0 - theta))
        return s

    def next(self) -> int:
        u = self.rng.random()
        uz = u * self.zetan
        if uz < 1.0:
            return 0
        if uz < 1.0 + 0.5 ** self.THETA:
            return 1
        return int(self.n * (self.eta * u - self.eta + 1.0) ** self.alpha)


#: YCSB core mixes: (read fraction, rmw fraction); the rest is a blind
#: update.  F's writes are read-modify-write of the same key.
YCSB_MIXES = {
    "A": (0.50, 0.0),        # 50% read / 50% update
    "B": (0.95, 0.0),        # 95% read /  5% update
    "C": (1.00, 0.0),        # read-only
    "F": (0.50, 0.50),       # 50% read / 50% read-modify-write
}


class YCSB:
    """Seeded, engine-independent YCSB op stream.

    The generator owns its RNG and an op counter, so two engines built
    over the same ``(n, mix, seed)`` observe the SAME key/op sequence
    op-for-op — the B-tree-vs-LSM state-equivalence tests and the
    fairness of the cross-engine benchmark both hang on this.  Values
    are derived from (key, op index), making every write distinct and
    the final state a fingerprint of which writer won each key.

    Works against any engine exposing ``begin``/``commit`` and a Txn
    with ``lookup``/``update`` (both ``StorageEngine`` and
    ``LSMEngine`` do)."""

    def __init__(self, engine, mix: str = "A", *, seed: int = 7,
                 zipfian: bool = True):
        assert mix in YCSB_MIXES, f"unknown YCSB mix {mix!r}"
        assert engine.cfg.value_size >= 32, "value too small for stamps"
        self.e = engine
        self.mix = mix
        self.read_frac, self.rmw_frac = YCSB_MIXES[mix]
        self.rng = np.random.default_rng(seed)
        self.zipf = ZipfGen(engine.n_tuples, self.rng) if zipfian \
            else None
        self.ops = 0
        self.reads = 0
        self.writes = 0

    def _key(self) -> int:
        if self.zipf is not None:
            return self.zipf.next()
        return int(self.rng.integers(0, self.e.n_tuples))

    def _val(self, key: int, op: int) -> bytes:
        stamp = b"%16d%16d" % (key, op)
        return stamp + bytes(self.e.cfg.value_size - len(stamp))

    def txn(self, rng=None):
        """One YCSB operation as a transaction fiber.  ``rng`` is
        ignored — the stream must not depend on which engine's
        run-loop RNG is passed in."""
        e = self.e
        op = self.ops
        self.ops += 1
        r = self.rng.random()
        key = self._key()
        e.charge(C_TX_S)
        t = e.begin()
        if r < self.read_frac:
            self.reads += 1
            v = yield from t.lookup(key)
            assert v is not None, f"missing key {key}"
            yield from e.commit(t)
            return
        self.writes += 1
        if r < self.read_frac + self.rmw_frac:
            v = yield from t.lookup(key)     # read-modify-write (F)
            assert v is not None, f"missing key {key}"
        ok = yield from t.update(key, self._val(key, op))
        assert ok
        yield from e.commit(t)


# ---------------------------------------------------------------------------
# TPC-C-lite
# ---------------------------------------------------------------------------

class TPCCLite:
    """Scaled-down TPC-C mix over the B-tree engine.

    Key space: one tree holding warehouse/customer/stock/order rows in
    disjoint key ranges. new-order touches 1 customer + 5–15 stock rows
    (update) + 1 order insert; payment updates warehouse + customer.
    1 warehouse ≈ in-memory (hot set < pool), 100 warehouses ≈
    out-of-memory — the paper's two regimes.
    """

    ITEMS_PER_WH = 20_000
    CUST_PER_WH = 3_000

    def __init__(self, engine, n_warehouses: int):
        self.e = engine
        self.W = n_warehouses
        self.order_seq = engine.n_tuples + 1_000_000

    def key_stock(self, w, i):
        return w * self.ITEMS_PER_WH + i

    def key_cust(self, w, c):
        return self.W * self.ITEMS_PER_WH + w * self.CUST_PER_WH + c

    @property
    def n_rows(self):
        return self.W * (self.ITEMS_PER_WH + self.CUST_PER_WH)

    def new_order(self, rng):
        e = self.e
        w = int(rng.integers(0, self.W))
        e.charge(2 * C_TX_S)                      # heavier logic than YCSB
        t = e.begin()
        c = int(rng.integers(0, self.CUST_PER_WH))
        v = yield from t.lookup(self.key_cust(w, c))
        n_items = int(rng.integers(5, 16))
        val = bytes(e.cfg.value_size)
        for _ in range(n_items):
            i = int(rng.integers(0, self.ITEMS_PER_WH))
            yield from t.update(self.key_stock(w, i), val)
        self.order_seq += 1
        yield from t.insert(self.order_seq, val)
        yield from e.commit(t)

    def payment(self, rng):
        e = self.e
        w = int(rng.integers(0, self.W))
        e.charge(C_TX_S)
        t = e.begin()
        c = int(rng.integers(0, self.CUST_PER_WH))
        val = bytes(e.cfg.value_size)
        yield from t.update(self.key_cust(w, c), val)
        yield from t.update(self.key_stock(w, 0), val)
        yield from e.commit(t)

    def order_status(self, rng):
        e = self.e
        w = int(rng.integers(0, self.W))
        e.charge(C_TX_S)
        c = int(rng.integers(0, self.CUST_PER_WH))
        yield from e.tree.lookup(self.key_cust(w, c))
        # last order of this customer (best-effort point lookup)
        if self.order_seq > e.n_tuples + 1_000_000:
            yield from e.tree.lookup(self.order_seq)

    def delivery(self, rng):
        e = self.e
        e.charge(2 * C_TX_S)
        t = e.begin()
        val = bytes(e.cfg.value_size)
        base = e.n_tuples + 1_000_000
        # mark up to 10 oldest undelivered orders
        for oid in range(max(base + 1, self.order_seq - 10),
                         self.order_seq + 1):
            yield from t.update(oid, val)
        yield from e.commit(t)

    def stock_level(self, rng):
        e = self.e
        w = int(rng.integers(0, self.W))
        e.charge(C_TX_S)
        i0 = int(rng.integers(0, self.ITEMS_PER_WH - 20))
        for i in range(i0, i0 + 20):       # scan 20 recent items' stock
            yield from e.tree.lookup(self.key_stock(w, i))

    def txn(self, rng):
        # TPC-C standard mix: NO 45%, P 43%, OS 4%, D 4%, SL 4%
        r = rng.random()
        if r < 0.45:
            yield from self.new_order(rng)
        elif r < 0.88:
            yield from self.payment(rng)
        elif r < 0.92:
            yield from self.order_status(rng)
        elif r < 0.96:
            yield from self.delivery(rng)
        else:
            yield from self.stock_level(rng)
