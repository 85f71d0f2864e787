"""Serving: the batched greedy loop. The KV pager comes in a later slice."""

from repro_torch.serve.loop import ServeLoop

__all__ = ["ServeLoop"]
