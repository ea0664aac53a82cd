"""cgroup-v2 worker isolation — resource bounds BEFORE a worker can dirty
the host (SURVEY §2.1 "cgroup support" row; reference:
src/ray/common/cgroup/cgroup_setup.h — per-worker cgroup under the node's
application slice, memory/cpu controllers).

Redesigned for the unified (v2) hierarchy only:

    <root>/rtpt-<session>/          node slice (controllers enabled here)
    <root>/rtpt-<session>/w-<id>/   one leaf per worker (pid in cgroup.procs)

 - memory.max  <- the worker's `memory` resource request (hard OOM bound —
   the kernel kills the worker instead of the host swapping; the node's
   RSS-polling memory monitor stays as the soft/graceful layer on top)
 - cpu.weight  <- proportional share from the worker's CPU request

Everything is best-effort and degrades to a no-op when the root isn't
writable (containers without cgroup delegation, non-root runs): isolation
is a hardening layer, never a boot requirement. The root is injectable so
tests run against a fake hierarchy in a tmpdir.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Optional

logger = logging.getLogger("ray_tpu_torch.cgroup")

DEFAULT_ROOT = "/sys/fs/cgroup"


def _write(path: str, value: str) -> bool:
    try:
        with open(path, "w") as f:
            f.write(value)
        return True
    except OSError:
        return False


class CgroupManager:
    """One per node daemon; owns the node slice and its worker leaves."""

    def __init__(self, session: str, root: str = DEFAULT_ROOT):
        self.root = root
        self.slice_dir = os.path.join(root, f"rtpt-{session}")
        self.enabled = False
        # v2 detection: the unified hierarchy exposes cgroup.controllers
        # at its root (v1 mounts do not)
        if not os.path.exists(os.path.join(root, "cgroup.controllers")):
            logger.debug("cgroup v2 root %s not present; isolation off",
                         root)
            return
        try:
            os.makedirs(self.slice_dir, exist_ok=True)
        except OSError:
            logger.debug("cgroup root %s not writable; isolation off", root)
            return
        # enable the controllers we use for the children of the slice;
        # partial success is fine (e.g. cpu missing under some delegations)
        _write(os.path.join(self.slice_dir, "cgroup.subtree_control"),
               "+memory +cpu")
        self.enabled = True

    # -- worker lifecycle --

    def create_worker_group(self, worker_hex: str,
                            memory_bytes: int = 0,
                            num_cpus: float = 0.0) -> Optional[str]:
        """Create the leaf and set bounds; returns its path (None = off)."""
        if not self.enabled:
            return None
        leaf = os.path.join(self.slice_dir, f"w-{worker_hex[:16]}")
        try:
            os.makedirs(leaf, exist_ok=True)
        except OSError:
            return None
        if memory_bytes > 0:
            _write(os.path.join(leaf, "memory.max"), str(int(memory_bytes)))
            # contain the kill to the worker: without this the kernel may
            # pick any process in the group's subtree
            _write(os.path.join(leaf, "memory.oom.group"), "1")
        if num_cpus > 0:
            # cpu.weight is proportional (default 100, range 1-10000):
            # scale so a 1-CPU worker keeps the default share
            weight = max(1, min(10000, int(100 * num_cpus)))
            _write(os.path.join(leaf, "cpu.weight"), str(weight))
        return leaf

    def attach(self, leaf: Optional[str], pid: int) -> bool:
        """Move a spawned worker into its leaf (post-fork attach, like the
        reference's AddProcessToCgroup)."""
        if not leaf:
            return False
        return _write(os.path.join(leaf, "cgroup.procs"), str(pid))

    def remove_worker_group(self, leaf: Optional[str]) -> None:
        if not leaf:
            return
        try:
            os.rmdir(leaf)  # cgroup dirs remove via rmdir once empty
        except OSError:
            pass

    def memory_events(self, leaf: Optional[str]) -> dict:
        """Parse memory.events (oom_kill count etc.) for death-cause
        reporting — lets the node answer `worker_fate` with 'oom' when the
        KERNEL did the killing, not just our RSS poller."""
        if not leaf:
            return {}
        try:
            with open(os.path.join(leaf, "memory.events")) as f:
                return {k: int(v) for k, v in
                        (line.split() for line in f if line.strip())}
        except (OSError, ValueError):
            return {}

    def shutdown(self) -> None:
        if not self.enabled:
            return
        try:
            for d in os.listdir(self.slice_dir):
                p = os.path.join(self.slice_dir, d)
                if os.path.isdir(p):
                    try:
                        os.rmdir(p)
                    except OSError:
                        pass
            os.rmdir(self.slice_dir)
        except OSError:
            # leaves with live pids can't be removed; leave for reboot
            shutil.rmtree(self.slice_dir, ignore_errors=True)
