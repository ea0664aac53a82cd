"""Distributed FIFO queue backed by a named actor.

Role-equivalent to the reference's Queue (reference:
python/ray/util/queue.py): producers/consumers in any process share one
queue actor; blocking get/put with timeouts (polling — the actor never
blocks its own lane, mirroring the reference's async-actor design in
spirit without requiring async actors). The port of
``ray_tpu/util/queue.py``.
"""

from __future__ import annotations

import collections
import time
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int = 0):
        self.maxsize = maxsize
        self.items: collections.deque = collections.deque()

    def put(self, item: Any) -> bool:
        if self.maxsize > 0 and len(self.items) >= self.maxsize:
            return False
        self.items.append(item)
        return True

    def put_batch(self, batch: List[Any]) -> int:
        n = 0
        for item in batch:
            if not self.put(item):
                break
            n += 1
        return n

    def get(self, n: int = 1) -> List[Any]:
        out = []
        while self.items and len(out) < n:
            out.append(self.items.popleft())
        return out

    def qsize(self) -> int:
        return len(self.items)


class Queue:
    def __init__(self, maxsize: int = 0, *, actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        cls = ray_tpu_torch.remote(**opts)(_QueueActor) if opts \
            else ray_tpu_torch.remote(_QueueActor)
        self._actor = cls.remote(maxsize)

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else 3600.0)
        while True:
            if ray_tpu_torch.get(self._actor.put.remote(item), timeout=30):
                return
            if not block or time.monotonic() >= deadline:
                raise Full("queue full")
            time.sleep(0.02)

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else 3600.0)
        while True:
            got = ray_tpu_torch.get(self._actor.get.remote(1), timeout=30)
            if got:
                return got[0]
            if not block or time.monotonic() >= deadline:
                raise Empty("queue empty")
            time.sleep(0.02)

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote(), timeout=30)

    def empty(self) -> bool:
        return self.qsize() == 0