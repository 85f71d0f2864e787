"""Flash attention forward: CUDA kernel, plain version, dispatching op."""
