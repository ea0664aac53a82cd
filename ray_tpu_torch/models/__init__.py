"""Model definitions of the PyTorch port (``ray_tpu.models`` counterparts)."""
