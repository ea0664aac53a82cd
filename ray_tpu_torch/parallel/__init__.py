"""Parallel layers of the PyTorch port (``ray_tpu.parallel`` counterparts).

The device mesh (``mesh.py``: ``MeshSpec``, ``build_mesh`` over
``torch.distributed``'s ``DeviceMesh``), the differentiable collectives
over a mesh axis (``collectives.py``), the fsdp gathers and their
prefetch (``fsdp_overlap.py``), and the routed MoE FFN (``moe.py``).
Axes, outermost to innermost: pp, dp, fsdp, sp, tp. Not in this port
yet: ring and Ulysses attention (sp > 1), the pipeline (pp > 1) and the
expert-parallel dispatch.

``moe`` imports the Llama model, which imports ``mesh``: it loads on
first use (PEP 562).
"""

from ray_tpu_torch.parallel.mesh import (MeshSpec, build_mesh,
                                         local_device_count, named_sharding,
                                         shard_constraint)

__all__ = ["MeshSpec", "build_mesh", "local_device_count", "named_sharding",
           "shard_constraint", "init_moe_params", "moe_ffn"]


def __getattr__(name: str):
    if name in ("init_moe_params", "moe_ffn"):
        from ray_tpu_torch.parallel import moe
        return getattr(moe, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
