"""Parallel layers of the PyTorch port (``ray_tpu.parallel`` counterparts).

The device mesh (``mesh.py``: ``MeshSpec``, ``build_mesh`` over
``torch.distributed``'s ``DeviceMesh``), the differentiable collectives
over a mesh axis (``collectives.py``), the fsdp gathers and their
prefetch (``fsdp_overlap.py``), ring and Ulysses attention over sp
(``ring_attention.py``, ``ulysses.py``, their shared math in
``attention.py``), the pipeline over pp (``pipeline.py``) and the routed
MoE FFN with its expert-parallel dispatch over ep (``moe.py``). Axes,
outermost to innermost: pp, dp, fsdp, sp, tp; ep lives on meshes made by
hand, as in the JAX tests.

``moe`` imports the Llama model, which imports ``mesh``: it loads on
first use (PEP 562).
"""

from ray_tpu_torch.parallel.mesh import (MeshSpec, build_mesh,
                                         local_device_count, named_sharding,
                                         shard_constraint)
from ray_tpu_torch.parallel.pipeline import pipeline_apply
from ray_tpu_torch.parallel.ring_attention import ring_attention
from ray_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = ["MeshSpec", "build_mesh", "local_device_count", "named_sharding",
           "shard_constraint", "ring_attention", "ulysses_attention",
           "pipeline_apply", "init_moe_params", "moe_ffn"]


def __getattr__(name: str):
    if name in ("init_moe_params", "moe_ffn"):
        from ray_tpu_torch.parallel import moe
        return getattr(moe, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
