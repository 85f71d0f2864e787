"""AdamW's gradient norm and update: CUDA kernels, plain version, torch ops."""
