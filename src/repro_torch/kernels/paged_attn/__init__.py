"""Paged-KV decode attention: CUDA kernel, plain version, dispatching op."""
