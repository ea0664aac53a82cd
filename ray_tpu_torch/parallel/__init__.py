"""Parallel layers of the PyTorch port (``ray_tpu.parallel`` counterparts).

Only what runs on one card is here: the routed MoE FFN. The mesh, the
collectives, ring and Ulysses attention, the pipeline and the
expert-parallel dispatch come with the device mesh.
"""

from ray_tpu_torch.parallel.moe import init_moe_params, moe_ffn

__all__ = ["init_moe_params", "moe_ffn"]
