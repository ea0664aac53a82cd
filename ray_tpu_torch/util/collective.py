"""Host-side collective groups over actors.

Role-equivalent to the reference's ray.util.collective (reference:
util/collective/collective.py:258 allreduce/:423 allgather/:472
reducescatter over NCCL/Gloo groups): collectives BETWEEN actor processes
for host-side numpy data — weight broadcast, metric reduction, rendezvous.

The port of ``ray_tpu/util/collective.py``: the same host-side group
actor, with no NCCL path (the JAX package has none either). Collectives
between devices run over torch.distributed (``ray_tpu_torch.parallel.
collectives``); this module is the control/host plane only, a Gloo-role
replacement implemented with a rendezvous actor (gather → reduce →
fan-out) on the cluster data plane, so arrays move through the shm object
store, not the RPC channel.

Each call takes numpy arrays, as the JAX package's does, or torch tensors
on the CPU or a card: a tensor goes to the host as a numpy array (bf16
and other types numpy lacks as float32), is reduced there as numpy is,
and comes back as a tensor of the caller's dtype on the caller's device.
torch is found through ``sys.modules``, never imported here.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch

_REDUCERS = {
    "sum": lambda arrs: np.sum(arrs, axis=0),
    "mean": lambda arrs: np.mean(arrs, axis=0),
    "max": lambda arrs: np.max(arrs, axis=0),
    "min": lambda arrs: np.min(arrs, axis=0),
}


class _GroupActor:
    """Rendezvous state for one collective group; one instance per group
    name, found via the named-actor directory."""

    #: rounds older than this are abandoned (a rank died/timed out mid-
    #: collective) — sweep them or the detached actor retains every
    #: contributed tensor forever
    ROUND_TTL_S = 600.0

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._lock = threading.Lock()
        self._rounds: Dict[str, dict] = {}

    def _round_locked(self, key: str) -> dict:
        """Sweep expired rounds and return (creating) `key`'s round.
        MUST be called with self._lock held: sweep+lookup+mutation stay
        one atomic section, so a concurrent sweep can never delete the
        round between lookup and deposit (advisor r2: orphaned-dict
        deposit left every rank blocked until timeout)."""
        now = time.monotonic()
        for k in [k for k, r in self._rounds.items()
                  if now - r["created"] > self.ROUND_TTL_S]:
            del self._rounds[k]
        r = self._rounds.get(key)
        if r is None:
            r = {"contribs": {}, "result": None, "done": False,
                 "created": now}
            self._rounds[key] = r
        return r

    def contribute(self, key: str, rank: int, value: Any, op: str,
                   kind: str) -> bool:
        """Deposit rank's tensor; the LAST depositor computes the result."""
        with self._lock:
            r = self._round_locked(key)
            r["contribs"][rank] = value
            if len(r["contribs"]) < self.world_size:
                return False
            ordered = [r["contribs"][i] for i in range(self.world_size)]
            if kind == "allreduce":
                r["result"] = _REDUCERS[op](ordered)
            elif kind == "allgather":
                r["result"] = ordered
            elif kind == "reducescatter":
                red = _REDUCERS[op](ordered)
                r["result"] = np.array_split(red, self.world_size)
            elif kind == "broadcast":
                r["result"] = r["contribs"][int(op)]  # op carries src rank
            else:
                raise ValueError(f"unknown collective {kind!r}")
            r["done"] = True
            return True

    def fetch(self, key: str, rank: int, kind: str):
        with self._lock:
            r = self._round_locked(key)
            if not r["done"]:
                return None
            if kind == "reducescatter":
                out = r["result"][rank]
            else:
                out = r["result"]
            r.setdefault("fetched", set()).add(rank)
            if len(r["fetched"]) >= self.world_size:
                self._rounds.pop(key, None)  # round complete: free memory
            return {"value": out}


def _torch_tensor(value) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(value, torch.Tensor)


def _to_host(value) -> np.ndarray:
    """A numpy array of ``value``'s data: a tensor leaves its device, and
    a dtype numpy has no counterpart for (bf16, fp8) travels as float32."""
    if not _torch_tensor(value):
        return np.asarray(value)
    t = value.detach().cpu()
    try:
        return t.numpy()
    except TypeError:
        return t.float().numpy()


def _like(out, value):
    """``out`` (a numpy array, or a list of them) as ``value`` came in: a
    tensor of its dtype on its device, or numpy as is."""
    if not _torch_tensor(value):
        return out
    torch = sys.modules["torch"]
    if isinstance(out, list):
        return [_like(o, value) for o in out]
    return torch.from_numpy(np.ascontiguousarray(out)).to(
        device=value.device, dtype=value.dtype)


class CollectiveGroup:
    """One rank's handle; construct via init_collective_group in each
    participating actor/process."""

    def __init__(self, name: str, world_size: int, rank: int):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self._seq = 0
        actor_name = f"__collective_{name}__"
        try:
            self._actor = ray_tpu_torch.get_actor(actor_name,
                                            namespace="collective")
        except ValueError:
            try:
                cls = ray_tpu_torch.remote(name=actor_name,
                                     namespace="collective",
                                     max_concurrency=max(4, world_size),
                                     lifetime="detached")(_GroupActor)
                self._actor = cls.remote(world_size)
            except Exception:  # lost the creation race
                self._actor = ray_tpu_torch.get_actor(actor_name,
                                                namespace="collective")

    def _collect(self, kind: str, value: Any, op: str,
                 timeout: float) -> Any:
        self._seq += 1
        key = f"{kind}:{self._seq}"
        ray_tpu_torch.get(self._actor.contribute.remote(
            key, self.rank, value, op, kind), timeout=timeout)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            out = ray_tpu_torch.get(self._actor.fetch.remote(
                key, self.rank, kind), timeout=timeout)
            if out is not None:
                return out["value"]
            time.sleep(0.01)
        raise TimeoutError(
            f"collective {kind} round {self._seq} of group "
            f"{self.name!r} timed out (world_size={self.world_size})")

    # -- API (mirrors reference util/collective) --

    def allreduce(self, array, op: str = "sum", *,
                  timeout: float = 120.0) -> np.ndarray:
        return _like(self._collect("allreduce", _to_host(array), op,
                                   timeout), array)

    def allgather(self, array, *, timeout: float = 120.0) -> List:
        return _like(self._collect("allgather", _to_host(array), "",
                                   timeout), array)

    def reducescatter(self, array, op: str = "sum", *,
                      timeout: float = 120.0) -> np.ndarray:
        return _like(self._collect("reducescatter", _to_host(array), op,
                                   timeout), array)

    def broadcast(self, array, src_rank: int = 0, *,
                  timeout: float = 120.0) -> np.ndarray:
        return _like(self._collect("broadcast", _to_host(array),
                                   str(src_rank), timeout), array)

    def barrier(self, *, timeout: float = 120.0) -> None:
        self._collect("allgather", np.zeros(1), "", timeout)


def init_collective_group(name: str, world_size: int,
                          rank: int) -> CollectiveGroup:
    """Join (creating if first) a named collective group
    (reference: util/collective/collective.py init_collective_group)."""
    return CollectiveGroup(name, world_size, rank)


def destroy_collective_group(name: str) -> None:
    """Tear down a group's detached rendezvous actor
    (reference: collective.py destroy_collective_group)."""
    try:
        actor = ray_tpu_torch.get_actor(f"__collective_{name}__",
                                  namespace="collective")
    except ValueError:
        return
    ray_tpu_torch.kill(actor)
