"""GPU accelerator manager: card detection, resources, visibility, leases.

The counterpart of the JAX package's TPU manager (``ray_tpu/accelerators/
tpu.py``), and role-equivalent to the reference's NVIDIA GPU manager
(reference: python/ray/_private/accelerators/nvidia_gpu.py —
``CUDA_VISIBLE_DEVICES`` detection and the visibility env a leased worker
gets):

 - a node advertises ``GPU`` (its card count) and, where it detected its
   cards, ``GPU-<model>`` beside it (``GPU-H100`` for "NVIDIA H100 80GB
   HBM3"), the counterpart of ``TPU-{version}``: a bundle or a node type
   can then name the card model;
 - a ``num_gpus=n`` lease gets a dedicated worker spawned with
   ``CUDA_VISIBLE_DEVICES`` naming only its cards, so a worker sees, and
   makes its context on, its own cards alone;
 - detection reads the environment, ``nvidia-smi`` or the NVIDIA driver's
   procfs entries: it never imports torch and never creates a CUDA
   context, since the daemons that detect own no card and a context costs
   device memory on every card it touches (the TPU probe stays env-only
   for the same reason).

There are no pod or gang resources: a request of any count from 1 to the
node's total is valid.
"""

from __future__ import annotations

import os
import re
import subprocess
from typing import Dict, List, Optional

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"

#: the NVIDIA driver's per-card procfs entries
_PROC_GPUS = "/proc/driver/nvidia/gpus"

#: a card's model: the first word after the vendor's in its name
#: ("NVIDIA H100 80GB HBM3" -> H100, "NVIDIA A100-SXM4-80GB" -> A100)
_MODEL = re.compile(r"^\S+\s+([A-Za-z0-9]+)")


class GPUAcceleratorManager:
    """Static helpers; instantiated nowhere (mirrors the reference ABC)."""

    # ------------------------------------------------------------- detection

    @staticmethod
    def detect() -> int:
        """The number of cards this process may use. Sources, in order:

          1. ``CUDA_VISIBLE_DEVICES`` when set: its entries up to the first
             invalid one (CUDA's own rule; "" or "-1" hide every card);
          2. ``nvidia-smi -L``, one line per card this machine (or
             container) gives access to;
          3. the driver's procfs entries, one directory per card.

        0 when none of them finds a card."""
        visible = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
        if visible is not None:
            return len(GPUAcceleratorManager.parse_visible(visible))
        try:
            out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                                 text=True, timeout=30)
            if out.returncode == 0:
                return sum(1 for line in out.stdout.splitlines()
                           if line.startswith("GPU "))
        except (OSError, subprocess.SubprocessError):
            pass
        try:
            return len([d for d in os.listdir(_PROC_GPUS)
                        if os.path.isdir(os.path.join(_PROC_GPUS, d))])
        except OSError:
            return 0

    @staticmethod
    def parse_visible(value: str) -> List[str]:
        """The entries of a ``CUDA_VISIBLE_DEVICES`` value that CUDA reads:
        it stops at the first invalid entry (a negative index)."""
        ids: List[str] = []
        for part in value.split(","):
            part = part.strip()
            if not part or part.startswith("-"):
                break
            ids.append(part)
        return ids

    # ------------------------------------------------------------- resources

    @staticmethod
    def model_counts() -> Dict[str, int]:
        """model -> count over the cards this process may use, from
        ``nvidia-smi --query-gpu=name`` for the ids ``CUDA_VISIBLE_DEVICES``
        names (every card without it). Empty when nvidia-smi is missing
        or fails, or no card is visible."""
        cmd = ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"]
        visible = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
        if visible is not None:
            ids = GPUAcceleratorManager.parse_visible(visible)
            if not ids:
                return {}
            cmd += ["-i", ",".join(ids)]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=30)
        except (OSError, subprocess.SubprocessError):
            return {}
        if out.returncode != 0:
            return {}
        counts: Dict[str, int] = {}
        for line in out.stdout.splitlines():
            m = _MODEL.match(line.strip())
            if m:
                counts[m.group(1)] = counts.get(m.group(1), 0) + 1
        return counts

    @staticmethod
    def node_resources(num_gpus: Optional[int] = None) -> Dict[str, float]:
        """Resources a node advertises: ``{"GPU": n}``, or nothing without
        a card. A node that detects its cards (``num_gpus`` None) also
        advertises ``GPU-<model>`` for each model among them; a count
        named by the caller gives ``{"GPU": n}`` alone."""
        if num_gpus is not None:
            return {"GPU": float(num_gpus)} if num_gpus > 0 else {}
        num_gpus = GPUAcceleratorManager.detect()
        if num_gpus <= 0:
            return {}
        res = {"GPU": float(num_gpus)}
        for model, n in GPUAcceleratorManager.model_counts().items():
            res[f"GPU-{model}"] = float(n)
        return res

    @staticmethod
    def validate_device_request(n: float, total: int) -> None:
        """A worker holds whole cards, at least one and at most the
        node's."""
        if n != int(n) or not 1 <= int(n) <= total:
            raise ValueError(
                f"requested {n} GPUs; a worker may hold a whole number of "
                f"cards from 1 to this node's {total}")

    @staticmethod
    def visibility_env(device_ids: List[int]) -> Dict[str, str]:
        """Env for a worker that owns ``device_ids`` on this node: set
        before the process makes its CUDA context. Where the node itself
        was started under ``CUDA_VISIBLE_DEVICES``, the ids index into
        that list."""
        parent = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
        names = GPUAcceleratorManager.parse_visible(parent) \
            if parent is not None else None
        return {CUDA_VISIBLE_DEVICES_ENV: ",".join(
            names[i] if names is not None and i < len(names) else str(i)
            for i in device_ids)}


class DeviceAllocator:
    """Per-node assignment of card ids to leased workers (the contract of
    the JAX package's ``ChipAllocator``)."""

    def __init__(self, num_devices: int):
        self.free: List[int] = list(range(num_devices))
        self.assigned: Dict[bytes, List[int]] = {}

    def allocate(self, worker_id: bytes, n: int) -> Optional[List[int]]:
        if len(self.free) < n:
            return None
        ids, self.free = self.free[:n], self.free[n:]
        self.assigned[worker_id] = ids
        return ids

    def release(self, worker_id: bytes) -> None:
        ids = self.assigned.pop(worker_id, None)
        if ids:
            self.release_devices(ids)

    def release_devices(self, ids: List[int]) -> None:
        """Return cards not (or no longer) tied to a worker id (e.g. a
        spawn that failed between allocation and registration)."""
        self.free.extend(ids)
        self.free.sort()
