"""MoE dispatch slot positions: CUDA kernel, plain version, dispatching op."""
