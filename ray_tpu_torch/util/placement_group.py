"""Placement groups: atomic multi-bundle resource reservations.

The port of ``ray_tpu/util/placement_group.py``. Role-equivalent to the
reference's placement-group API (reference:
python/ray/util/placement_group.py:145 `placement_group`, PlacementGroup
handle at :41), backed by the head's pending-queue scheduler which drives
the C++ bundle policies (PACK/SPREAD/STRICT_PACK/STRICT_SPREAD — reference:
src/ray/raylet/scheduling/policy/bundle_scheduling_policy.h:82-106,
gcs_placement_group_manager.h:228).

Bundles reserve cards through ``GPU`` (a node advertises its card count,
``accelerators/gpu.py``): ``{"GPU": 1, "CPU": 1}`` holds one card, and a
task or actor placed in that bundle gets a worker that sees only its card
through ``CUDA_VISIBLE_DEVICES``. STRICT_PACK means "same host" (the JAX
package's TPU bundles name a slice's gang resource, where it means "same
slice").
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch.core.ids import PlacementGroupID
from ray_tpu_torch.core.worker import require_connected
from ray_tpu_torch.exceptions import PlacementGroupUnschedulableError

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID,
                 bundles: List[Dict[str, float]], strategy: str,
                 name: str = ""):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)

    def state(self) -> dict:
        worker = require_connected()
        info = worker.backend.get_placement_group(self.id.binary())
        if info is None:
            return {"state": "REMOVED"}
        return info

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        """Block until all bundles are reserved (reference: pg.wait())."""
        deadline = time.monotonic() + timeout_seconds
        while time.monotonic() < deadline:
            st = self.state()
            if st.get("state") == "CREATED":
                return True
            if st.get("state") in ("REMOVED", "INFEASIBLE"):
                return False
            time.sleep(0.02)
        return False

    def ready(self, timeout_seconds: float = 30.0) -> "PlacementGroup":
        """wait() that raises on failure; returns self for chaining."""
        if not self.wait(timeout_seconds):
            st = self.state().get("state")
            raise PlacementGroupUnschedulableError(
                f"placement group {self.id.hex()[:12]} not ready "
                f"(state={st}, strategy={self.strategy}, "
                f"bundles={self.bundles})")
        return self

    def bundle_node(self, index: int) -> Optional[str]:
        """Node id hosting bundle `index` (None until CREATED)."""
        st = self.state()
        nodes = st.get("nodes")
        return nodes[index] if nodes else None

    def __reduce__(self):
        return (PlacementGroup,
                (self.id, self.bundles, self.strategy, self.name))


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be non-empty resource dicts")
    for b in bundles:
        for k, v in b.items():
            if v <= 0:
                raise ValueError(f"bundle resource {k}={v} must be positive")
    worker = require_connected()
    pg_id = PlacementGroupID.of(worker.job_id)
    worker.backend.create_placement_group(
        pg_id.binary(), [dict(b) for b in bundles], strategy, name)
    return PlacementGroup(pg_id, [dict(b) for b in bundles], strategy, name)


def remove_placement_group(pg: PlacementGroup) -> None:
    worker = require_connected()
    worker.backend.remove_placement_group(pg.id.binary())
