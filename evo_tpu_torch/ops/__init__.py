"""Ops of the PyTorch port: the CUDA kernels' wrappers beside their plain
versions, and plain tensor ops (counterparts of `evo_tpu/ops`)."""
