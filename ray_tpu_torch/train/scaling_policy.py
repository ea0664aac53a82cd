"""ScalingPolicy: decides the worker-group size across (re)schedules.

Reference: python/ray/train/v2/_internal/execution/scaling_policy/
scaling_policy.py:29 — the controller consults a policy seam for a
ResizeDecision at every scheduling pass, separate from the FailurePolicy
that decides whether to keep going at all. A resize is a mesh resize:
the new group builds its mesh over fewer or more ranks and restores from
the latest checkpoint, whose pieces re-shard onto any mesh
(train/checkpoint.py). The PyTorch port of
``ray_tpu/train/scaling_policy.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ray_tpu_torch.train.worker_group import WorkerGroupError


class ScalingPolicy:
    """Decides the group size for the next scheduling pass."""

    def initial_size(self, capacity: Callable[[], Dict[str, float]]) -> int:
        raise NotImplementedError

    def after_failure(self, current_size: int,
                      error: WorkerGroupError) -> int:
        """Group size for the restart after a worker-group failure."""
        raise NotImplementedError

    def grow_target(self, current_size: int,
                    capacity: Callable[[], Dict[str, float]]
                    ) -> Optional[int]:
        """Bigger size worth restarting into mid-run, or None.

        Consulted periodically by the controller while a group runs; a
        non-None answer interrupts the group, which restarts at the new
        size from the latest checkpoint (capacity-gain elasticity)."""
        return None


class FixedScalingPolicy(ScalingPolicy):
    """Always the configured size (reference v1 semantics: a dead worker
    restarts the group at the same world size)."""

    def __init__(self, num_workers: int):
        self.num_workers = num_workers

    def initial_size(self, capacity) -> int:
        return self.num_workers

    def after_failure(self, current_size: int,
                      error: WorkerGroupError) -> int:
        return self.num_workers


class ElasticScalingPolicy(ScalingPolicy):
    """Size the group to [min_workers, max_workers] elastically.

    - At scheduling time: the largest size the cluster can host right now
      (so a half-provisioned pod starts training instead of waiting).
    - After a failure: one worker smaller (a lost slice/host keeps the run
      alive at reduced width; the next scheduling pass grows back if the
      capacity returned), never below min_workers.

    Reference: scaling_policy.py:29 ResizeDecision; SURVEY §7 hard part
    "slice loss => re-mesh + restore".
    """

    def __init__(self, min_workers: int, max_workers: int,
                 resources_per_worker: Optional[Dict[str, float]] = None):
        if min_workers < 1 or min_workers > max_workers:
            raise ValueError(
                f"need 1 <= min_workers <= max_workers, got "
                f"{min_workers}..{max_workers}")
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.resources_per_worker = dict(resources_per_worker or {})

    def _fits(self, capacity: Dict[str, float], n: int) -> bool:
        for res, per in self.resources_per_worker.items():
            if per > 0 and capacity.get(res, 0.0) < per * n:
                return False
        return True

    def initial_size(self, capacity) -> int:
        try:
            avail = capacity()
        except Exception:  # noqa: BLE001 — no cluster info: be optimistic
            return self.max_workers
        for n in range(self.max_workers, self.min_workers, -1):
            if self._fits(avail, n):
                return n
        return self.min_workers

    def after_failure(self, current_size: int,
                      error: WorkerGroupError) -> int:
        return max(self.min_workers, current_size - 1)

    def grow_target(self, current_size: int, capacity) -> Optional[int]:
        if current_size >= self.max_workers:
            return None
        try:
            avail = capacity()  # excludes what the running group holds
        except Exception:  # noqa: BLE001 — no cluster info: stay put
            return None
        target = current_size
        for extra in range(1, self.max_workers - current_size + 1):
            if self._fits(avail, extra):
                target = current_size + extra
        return target if target > current_size else None
