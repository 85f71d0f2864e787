"""Serving: the batched greedy loop, and the KV pager (the paper's buffer
manager applied to KV pages, whose frame table feeds the paged kernel)."""

from repro_torch.serve.kv_paging import KVPager, PagerConfig, SeqState
from repro_torch.serve.loop import ServeLoop

__all__ = ["KVPager", "PagerConfig", "SeqState", "ServeLoop"]
