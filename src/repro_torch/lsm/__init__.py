"""LSM storage engine on the ring runtime (ROADMAP: background-I/O
interference).  See docs/lsm.md for the design and the interference /
in-kernel-offload study, and ``repro.lsm.engine.LSMEngine`` for the
engine itself (same commit/lookup surface as ``StorageEngine``)."""

from repro_torch.lsm.engine import LSMEngine
from repro_torch.lsm.memtable import Memtable
from repro_torch.lsm.recovery import recover_lsm
from repro_torch.lsm.sstable import SSTable, build_table_pages, open_from_image

__all__ = ["LSMEngine", "Memtable", "SSTable", "build_table_pages",
           "open_from_image", "recover_lsm"]
