"""The plain reference of the benchmark's models: fp32 PyTorch with TF32
off, no kernel, no cache and no batching of the program. It imports
nothing of the program and takes nothing the program made: its weights
come from the seed through ``bench.weights``, one layer at a time."""
