"""Mamba2 SSD intra-chunk step: CUDA kernel, plain versions, dispatching op."""
