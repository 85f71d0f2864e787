"""In-memory memtable: the LSM engine's write buffer.

A plain dict keyed by int64 key; each entry carries the COMMIT LSN of
the transaction that installed it, so concurrent appliers (which may
reach a shared key out of commit order — the group-commit gate resumes
fibers in scheduler order) obey the same per-key write rule as the
B-tree engine's ``_apply``: a later-committed value is never
overwritten by an earlier one.  That makes live state provably equal
to recovery's commit-LSN-ordered logical replay (see
``repro.lsm.recovery``).

``approx_bytes`` tracks the on-disk footprint the table would have
(entry framing included) — the flush trigger compares it against
``EngineConfig.memtable_bytes``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

#: per-entry framing bytes in an SSTable data page (<qH> key, vlen)
ENTRY_HDR = 10


class Memtable:
    __slots__ = ("data", "approx_bytes")

    def __init__(self):
        # key -> (value, commit lsn of the installing txn)
        self.data: Dict[int, Tuple[bytes, int]] = {}
        self.approx_bytes = 0

    def __len__(self) -> int:
        return len(self.data)

    def put(self, key: int, value: bytes, clsn: int) -> bool:
        """Install ``value`` under the per-key write rule; returns False
        when a later-committed writer already holds the key."""
        cur = self.data.get(key)
        if cur is not None:
            if cur[1] > clsn:
                return False
            self.approx_bytes += len(value) - len(cur[0])
        else:
            self.approx_bytes += ENTRY_HDR + len(value)
        self.data[key] = (value, clsn)
        return True

    def get(self, key: int) -> Optional[Tuple[bytes, int]]:
        return self.data.get(key)

    def sorted_entries(self) -> Iterator[Tuple[int, bytes]]:
        """(key, value) in key order — the flush path's input."""
        for k in sorted(self.data):
            yield k, self.data[k][0]
