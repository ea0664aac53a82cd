"""Run/Scaling/Failure/Checkpoint configs — the PyTorch port of
``ray_tpu/train/config.py``: ``ScalingConfig`` speaks worker processes,
one card each, and a ``MeshSpec`` laid over their ranks.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

from ray_tpu_torch.parallel.mesh import MeshSpec


@dataclasses.dataclass
class ScalingConfig:
    """How much hardware a run gets and how the mesh is laid over it.

    num_workers: worker processes, one rank of the process group each.
    mesh: parallelism degrees laid over the ranks.
    use_gpu: each worker leases ``gpus_per_worker`` cards (the runtime's
        GPU lease: a worker of its own that sees only its cards) and
        trains on ``cuda:0``; False: CPU workers; None: leases whenever
        the cluster has a card (``resolve``).
    """

    num_workers: int = 1
    #: Elastic training (reference: train/v2 ScalingPolicy seam,
    #: scaling_policy.py:29): when set below num_workers, the controller
    #: sizes each (re)schedule to what the cluster can host in
    #: [min_workers, num_workers] — a lost worker restarts the group one
    #: smaller (re-meshed + checkpoint-restored) instead of failing the
    #: run. Requires a -1 "fill" axis in `mesh`.
    min_workers: Optional[int] = None
    #: elastic grow-back: how often (seconds) the controller polls cluster
    #: capacity for a mid-run upscale (interrupt + restore at bigger size)
    grow_poll_s: float = 30.0
    #: hysteresis — grow suppression window (seconds) after a FAILURE
    #: restart: a killed worker's freed resources read as "capacity
    #: gained", and without a cooldown the shrunken group would be
    #: interrupted to grow right back (shrink->grow oscillation on every
    #: capacity churn).
    grow_cooldown_s: float = 30.0
    #: hysteresis — minimum seconds a freshly started group runs before
    #: the grow monitor may interrupt it
    grow_min_dwell_s: float = 5.0
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    use_gpu: Optional[bool] = None
    gpus_per_worker: int = 1
    resources_per_worker: Optional[dict] = None
    #: host:port of the process group's rendezvous; None: a free port on
    #: the controller's host
    coordinator_address: Optional[str] = None

    def resolve(self, cluster_resources: dict) -> "ScalingConfig":
        """This config with ``use_gpu`` decided: None becomes True when
        the cluster has a card."""
        if self.use_gpu is not None:
            return self
        return dataclasses.replace(
            self, use_gpu=cluster_resources.get("GPU", 0) > 0)

    def wants_distributed(self) -> bool:
        """Whether the workers join a process group: with a card, more
        than one worker, or a mesh other than the default."""
        return bool(self.use_gpu) or self.num_workers > 1 \
            or self.mesh != MeshSpec()

    def worker_resources(self) -> dict:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu and self.gpus_per_worker:
            res["GPU"] = float(self.gpus_per_worker)
        return res


@dataclasses.dataclass
class FailureConfig:
    """Reference: train/v2/.../failure_handling/failure_policy.py:14."""

    max_failures: int = 0  # worker-group restarts before giving up


@dataclasses.dataclass
class CheckpointConfig:
    """Reference: air/config.py CheckpointConfig."""

    num_to_keep: Optional[int] = None
    checkpoint_frequency: int = 0  # steps between auto-checkpoints (0 = off)
    #: Overlap saves with compute (TorchTitan-style async distributed
    #: checkpointing): report() only pays the device→host copy, while
    #: serialization + upload + commit run on a background writer (one
    #: save in flight; a second blocks until the slot frees). Off by
    #: default: sync saves return with the manifest committed, which
    #: deterministic tests and scripts rely on.
    async_save: bool = False
    #: how long rank 0 waits for every host's shard sidecar before
    #: declaring the save abandoned (checkpoint_abandoned journal record)
    barrier_timeout_s: float = 60.0


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)

    def resolve_storage(self) -> str:
        base = self.storage_path or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch_results")
        name = self.name or "run"
        path = os.path.join(base, name)
        os.makedirs(path, exist_ok=True)
        return path
