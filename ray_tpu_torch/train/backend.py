"""torch.distributed backend — worker bootstrap, the port of
``ray_tpu/train/backend.py``.

Every train worker process joins one process group before the user loop
(``setup_torch_worker``), rendezvousing at the coordinator address the
controller picked: NCCL when the worker holds a card (the runtime's GPU
lease gives it a worker of its own that sees only its card, so the
device is ``cuda:0``), gloo otherwise. After that ``global_mesh`` lays
``ScalingConfig.mesh`` over the ranks. A worker process may run several
groups in turn (a restart, a resize, another run): ``teardown_torch_worker``
destroys the group at the end of each run, so the next one can start.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh, group_timeout

#: meshes built over the current group, by spec: ``build_mesh`` creates
#: process groups, which every rank must do the same number of times
_meshes: Dict[MeshSpec, Any] = {}


def setup_torch_worker(dist_cfg: Dict[str, Any]) -> None:
    """Join this worker process to the run's process group.

    dist_cfg keys: coordinator (host:port), world_size, rank, use_gpu
    (NCCL on the card, else gloo). With ``use_gpu`` a worker that finds no card raises, and so does NCCL failing to
    initialise: the group runs one all-reduce on the device before the
    loop starts.

    The group, and every group a mesh builds over it, times out after
    ``parallel.mesh.GROUP_TIMEOUT_S``: a rank whose peer is gone raises
    there (on NCCL the watchdog ends the process about a minute later)
    and the controller sees the failure, where torch's defaults would
    wait 30 minutes (gloo) or 10 (NCCL)."""
    import torch
    import torch.distributed as dist
    use_gpu = bool(dist_cfg.get("use_gpu"))
    if use_gpu:
        if not torch.cuda.is_available():
            raise RuntimeError("ScalingConfig(use_gpu=True), but this worker "
                               "finds no card (torch.cuda.is_available() "
                               "is False)")
        torch.cuda.set_device(0)
    backend = "nccl" if use_gpu else "gloo"
    teardown_torch_worker()   # a group a killed run left in this process
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", 0)
    dist.init_process_group(
        backend, init_method=f"tcp://{dist_cfg['coordinator']}",
        world_size=int(dist_cfg["world_size"]), rank=int(dist_cfg["rank"]),
        timeout=group_timeout(), **kwargs)
    probe = torch.ones(1, device="cuda" if backend == "nccl" else "cpu")
    dist.all_reduce(probe)
    if int(probe.item()) != dist.get_world_size():
        raise RuntimeError(f"{backend} all-reduce over "
                           f"{dist.get_world_size()} ranks gave "
                           f"{probe.item()}")


def teardown_torch_worker() -> None:
    """Destroy this process's group (and the meshes built over it)."""
    import torch.distributed as dist
    _meshes.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def _node_ids():
    import torch.distributed as dist

    from ray_tpu_torch.core.worker import global_worker
    mine = global_worker.node_id
    mine = mine.hex() if hasattr(mine, "hex") else str(mine)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine)
    return out


def global_mesh(spec: Optional[MeshSpec] = None):
    """The job-wide DeviceMesh (call after setup_torch_worker); built once
    per spec and group. With dcn axes the ranks group by node."""
    spec = spec or MeshSpec(dp=-1)
    if spec not in _meshes:
        _meshes[spec] = build_mesh(
            spec, node_ids=_node_ids() if spec.num_slices > 1 else None)
    return _meshes[spec]


def process_index() -> int:
    """This process's rank (0 without a group)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0
