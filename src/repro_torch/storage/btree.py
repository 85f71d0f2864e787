"""Disk-resident B-tree over the buffer pool (paper §3.1's index).

Fixed-size pages; int64 keys; fixed-size values. All traversals are fiber
generators (``yield from tree.lookup(...)``) — every node access goes
through ``pool.fix`` and may suspend on a page fault.

Concurrency follows the paper exactly: fibers are cooperative, so no
latches; a traversal records the tree version at entry and RESTARTS if a
structural change (split) happened across any suspension point.

Page layout (little-endian):
    [0]    u8   node type: 0 = leaf, 1 = internal
    [1:3]  u16  nkeys
    [4:12] u64  page LSN — WAL offset of the last APPLY record that
                modified this page (0 for bulk-loaded pages; see
                repro.wal).  The buffer pool refuses to write back a
                dirty page until the log is durable up to this LSN.
    leaf:     keys i64[fanout] | values u8[fanout × value_size]
    internal: keys i64[fanout] | children i32[fanout + 1]
"""

from __future__ import annotations

import struct
from typing import Generator, List, Optional, Tuple

import numpy as np

from repro_torch.bufferpool.pool import PAGE_LSN_OFF

HDR = 12


def page_lsn(buf) -> int:
    """Read a page's LSN straight from its header bytes."""
    return struct.unpack_from("<Q", buf, PAGE_LSN_OFF)[0]


def set_page_lsn(buf, lsn: int) -> None:
    struct.pack_into("<Q", buf, PAGE_LSN_OFF, lsn)


def leaf_fanout(page_size: int, value_size: int) -> int:
    return (page_size - HDR) // (8 + value_size)


def internal_fanout(page_size: int) -> int:
    return (page_size - HDR - 4) // (8 + 4)


class _Node:
    """numpy view over a page buffer."""

    def __init__(self, buf: bytearray, page_size: int, value_size: int):
        self.raw = np.frombuffer(buf, dtype=np.uint8, count=page_size)
        self.page_size = page_size
        self.value_size = value_size
        self.lf = leaf_fanout(page_size, value_size)
        self.inf = internal_fanout(page_size)

    # header
    @property
    def is_leaf(self) -> bool:
        return self.raw[0] == 0

    @is_leaf.setter
    def is_leaf(self, v: bool):
        self.raw[0] = 0 if v else 1

    @property
    def nkeys(self) -> int:
        return int(self.raw[1]) | (int(self.raw[2]) << 8)

    @nkeys.setter
    def nkeys(self, n: int):
        self.raw[1] = n & 0xFF
        self.raw[2] = (n >> 8) & 0xFF

    @property
    def lsn(self) -> int:
        return int(self.raw[PAGE_LSN_OFF:PAGE_LSN_OFF + 8]
                   .view(np.uint64)[0])

    @lsn.setter
    def lsn(self, v: int):
        self.raw[PAGE_LSN_OFF:PAGE_LSN_OFF + 8].view(np.uint64)[0] = v

    # views
    def keys(self) -> np.ndarray:
        fan = self.lf if self.is_leaf else self.inf
        return self.raw[HDR:HDR + 8 * fan].view(np.int64)

    def values(self) -> np.ndarray:
        off = HDR + 8 * self.lf
        return self.raw[off:off + self.lf * self.value_size].reshape(
            self.lf, self.value_size)

    def children(self) -> np.ndarray:
        off = HDR + 8 * self.inf
        return self.raw[off:off + 4 * (self.inf + 1)].view(np.int32)


class BTree:
    def __init__(self, pool, root_pid: int, next_pid: int, *,
                 value_size: int = 128):
        self.pool = pool
        self.root = root_pid
        self.next_pid = next_pid
        self.value_size = value_size
        self.version = 0                   # bumped on splits
        self.restarts = 0

    def _node(self, idx: int) -> _Node:
        return _Node(self.pool.page(idx), self.pool.cfg.page_size,
                     self.value_size)

    # ------------------------------------------------------------- lookup

    def lookup(self, key: int) -> Generator:
        while True:
            v0 = self.version
            pid = self.root
            while True:
                idx = yield from self.pool.fix(pid)
                if self.version != v0:       # world changed: restart
                    self.pool.unfix(idx)
                    self.restarts += 1
                    break
                node = self._node(idx)
                n = node.nkeys
                if node.is_leaf:
                    keys = node.keys()[:n]
                    j = int(np.searchsorted(keys, key))
                    out = None
                    if j < n and keys[j] == key:
                        out = bytes(node.values()[j])
                    self.pool.unfix(idx)
                    return out
                j = int(np.searchsorted(node.keys()[:n], key, side="right"))
                pid = int(node.children()[j])
                self.pool.unfix(idx)

    # ------------------------------------------------------------- update

    def update(self, key: int, value: bytes,
               oplog: Optional[List] = None) -> Generator:
        """``oplog`` (WAL hook): a per-call list that collects
        ("upsert", pid, key, value) for an in-place leaf write or
        ("img", pid) for each page a split touched, so the engine can
        frame one APPLY record per tree op (see repro.wal).  Must be
        per-call — fibers suspend mid-traversal, so shared state would
        interleave concurrent transactions' entries."""
        while True:
            v0 = self.version
            pid = self.root
            while True:
                idx = yield from self.pool.fix(pid)
                if self.version != v0:
                    self.pool.unfix(idx)
                    self.restarts += 1
                    break
                node = self._node(idx)
                n = node.nkeys
                if node.is_leaf:
                    keys = node.keys()[:n]
                    j = int(np.searchsorted(keys, key))
                    ok = j < n and keys[j] == key
                    if ok:
                        node.values()[j, :len(value)] = np.frombuffer(
                            value, np.uint8)
                        if oplog is not None:
                            oplog.append(("upsert", pid, key, value))
                    self.pool.unfix(idx, dirty=ok)
                    return ok
                j = int(np.searchsorted(node.keys()[:n], key, side="right"))
                pid = int(node.children()[j])
                self.pool.unfix(idx)

    # ------------------------------------------------------------- insert

    def insert(self, key: int, value: bytes,
               oplog: Optional[List] = None) -> Generator:
        """Insert with root-to-leaf split propagation. The whole path is
        pinned before any modification, so no fiber observes a half-split
        (between yields the world cannot change — cooperative scheduling).
        ``oplog``: per-call WAL hook, see ``update``.
        """
        while True:
            v0 = self.version
            path: List[Tuple[int, int]] = []       # (pid, frame_idx)
            pid = self.root
            restart = False
            while True:
                idx = yield from self.pool.fix(pid)
                if self.version != v0:
                    self.pool.unfix(idx)
                    for _, i in path:
                        self.pool.unfix(i)
                    path = []
                    self.restarts += 1
                    restart = True
                    break
                node = self._node(idx)
                if node.is_leaf:
                    path.append((pid, idx))
                    break
                path.append((pid, idx))
                j = int(np.searchsorted(node.keys()[:node.nkeys], key,
                                        side="right"))
                pid = int(node.children()[j])
            if restart:
                continue
            # leaf insert (no yields from here on)
            self._insert_pinned(path, key, value, oplog)
            for _, i in reversed(path):
                self.pool.unfix(i, dirty=True)
            return True

    def _insert_pinned(self, path, key: int, value: bytes,
                       oplog: Optional[List] = None) -> None:
        pid, idx = path[-1]
        node = self._node(idx)
        n = node.nkeys
        keys = node.keys()
        j = int(np.searchsorted(keys[:n], key))
        if j < n and keys[j] == key:               # upsert
            node.values()[j, :len(value)] = np.frombuffer(value, np.uint8)
            if oplog is not None:
                oplog.append(("upsert", pid, key, value))
            return
        if n < node.lf:
            keys[j + 1:n + 1] = keys[j:n].copy()
            vals = node.values()
            vals[j + 1:n + 1] = vals[j:n].copy()
            keys[j] = key
            vals[j, :len(value)] = np.frombuffer(value, np.uint8)
            node.nkeys = n + 1
            if oplog is not None:
                oplog.append(("upsert", pid, key, value))
            return
        # leaf split
        self._split_insert(path, key, value, oplog)

    def _split_insert(self, path, key: int, value: bytes,
                      oplog: Optional[List] = None) -> None:
        """Split the full leaf, then propagate (allocating fresh in-pool
        pages; they are written back by normal eviction)."""
        self.version += 1
        pid, idx = path[-1]
        node = self._node(idx)
        n = node.nkeys
        mid = n // 2
        new_pid = self.next_pid
        self.next_pid += 1
        nidx = self.pool.adopt_new_page(new_pid)
        nnode = self._node(nidx)
        nnode.is_leaf = True
        # move upper half
        nnode.keys()[:n - mid] = node.keys()[mid:n]
        nnode.values()[:n - mid] = node.values()[mid:n]
        nnode.nkeys = n - mid
        node.nkeys = mid
        sep = int(nnode.keys()[0])
        # insert into the correct half
        tgt_idx = idx if key < sep else nidx
        tgt_node = self._node(tgt_idx)
        m = tgt_node.nkeys
        ks = tgt_node.keys()
        j = int(np.searchsorted(ks[:m], key))
        ks[j + 1:m + 1] = ks[j:m].copy()
        vals = tgt_node.values()
        vals[j + 1:m + 1] = vals[j:m].copy()
        ks[j] = key
        vals[j, :len(value)] = np.frombuffer(value, np.uint8)
        tgt_node.nkeys = m + 1
        if oplog is not None:
            oplog.append(("img", pid))
            oplog.append(("img", new_pid))
        self.pool.unfix_new(nidx)
        self._insert_sep(path[:-1], sep, new_pid, pid, oplog)

    def _insert_sep(self, path, sep: int, right_pid: int,
                    left_pid: int, oplog: Optional[List] = None) -> None:
        if not path:
            # new root
            new_root_pid = self.next_pid
            self.next_pid += 1
            ridx = self.pool.adopt_new_page(new_root_pid)
            rnode = self._node(ridx)
            rnode.is_leaf = False
            rnode.nkeys = 1
            rnode.keys()[0] = sep
            rnode.children()[0] = left_pid
            rnode.children()[1] = right_pid
            self.root = new_root_pid
            if oplog is not None:
                oplog.append(("img", new_root_pid))
            self.pool.unfix_new(ridx)
            return
        pid, idx = path[-1]
        node = self._node(idx)
        n = node.nkeys
        if n < node.inf:
            keys = node.keys()
            ch = node.children()
            j = int(np.searchsorted(keys[:n], sep))
            keys[j + 1:n + 1] = keys[j:n].copy()
            ch[j + 2:n + 2] = ch[j + 1:n + 1].copy()
            keys[j] = sep
            ch[j + 1] = right_pid
            node.nkeys = n + 1
            if oplog is not None:
                oplog.append(("img", pid))
            return
        # split internal node
        mid = n // 2
        up = int(node.keys()[mid])
        new_pid = self.next_pid
        self.next_pid += 1
        nidx = self.pool.adopt_new_page(new_pid)
        nnode = self._node(nidx)
        nnode.is_leaf = False
        cnt = n - mid - 1
        nnode.keys()[:cnt] = node.keys()[mid + 1:n]
        nnode.children()[:cnt + 1] = node.children()[mid + 1:n + 1]
        nnode.nkeys = cnt
        node.nkeys = mid
        # insert sep into the proper half
        tgt_idx, tgt_pid = (idx, pid) if sep < up else (nidx, new_pid)
        tnode = self._node(tgt_idx)
        m = tnode.nkeys
        keys = tnode.keys()
        ch = tnode.children()
        j = int(np.searchsorted(keys[:m], sep))
        keys[j + 1:m + 1] = keys[j:m].copy()
        ch[j + 2:m + 2] = ch[j + 1:m + 1].copy()
        keys[j] = sep
        ch[j + 1] = right_pid
        tnode.nkeys = m + 1
        if oplog is not None:
            oplog.append(("img", pid))
            oplog.append(("img", new_pid))
        self.pool.unfix_new(nidx)
        self._insert_sep(path[:-1], up, new_pid, pid, oplog)


# ---------------------------------------------------------------------------
# Bottom-up bulk load straight into the disk image (no pool traffic)
# ---------------------------------------------------------------------------

def bulk_load(disk_image: bytearray, keys: np.ndarray, values: np.ndarray,
              *, page_size: int = 4096, value_size: int = 128,
              fill: float = 0.8, start_pid: int = 0
              ) -> Tuple[int, int]:
    """Build a B-tree over sorted ``keys`` directly in the disk image.
    Returns (root_pid, next_free_pid)."""
    assert np.all(np.diff(keys) > 0), "keys must be sorted unique"
    lf = max(2, int(leaf_fanout(page_size, value_size) * fill))
    inf = max(2, int(internal_fanout(page_size) * fill))
    pid = start_pid

    # leaves
    level: List[Tuple[int, int]] = []     # (first_key, pid)
    n = len(keys)
    for s in range(0, n, lf):
        e = min(s + lf, n)
        buf = bytearray(page_size)
        node = _Node(buf, page_size, value_size)
        node.is_leaf = True
        node.nkeys = e - s
        node.keys()[:e - s] = keys[s:e]
        node.values()[:e - s, :values.shape[1]] = values[s:e]
        disk_image[pid * page_size:(pid + 1) * page_size] = buf
        level.append((int(keys[s]), pid))
        pid += 1

    # internals
    while len(level) > 1:
        nxt: List[Tuple[int, int]] = []
        for s in range(0, len(level), inf + 1):
            grp = level[s:s + inf + 1]
            buf = bytearray(page_size)
            node = _Node(buf, page_size, value_size)
            node.is_leaf = False
            node.nkeys = len(grp) - 1
            node.children()[:len(grp)] = [g[1] for g in grp]
            if len(grp) > 1:
                node.keys()[:len(grp) - 1] = [g[0] for g in grp[1:]]
            disk_image[pid * page_size:(pid + 1) * page_size] = buf
            nxt.append((grp[0][0], pid))
            pid += 1
        level = nxt
    return level[0][1], pid
