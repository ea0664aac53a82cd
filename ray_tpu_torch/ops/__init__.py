"""Ops of the PyTorch port: each hand-written CUDA kernel beside its plain
PyTorch version (``ray_tpu.ops`` counterparts)."""
