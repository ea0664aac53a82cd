"""ActorPool — multiplex tasks over a fixed set of actors.

Role-equivalent to the reference's ActorPool (reference:
python/ray/util/actor_pool.py): submit(fn, value) dispatches
fn(actor, value) to a free actor; results stream back in completion or
submission order. The port of ``ray_tpu/util/actor_pool.py``.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, List

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: List[Any]):
        if not actors:
            raise ValueError("ActorPool needs at least one actor")
        self._idle = list(actors)
        self._backlog: collections.deque = collections.deque()
        self._inflight = {}
        self._ref_by_seq = {}
        self._submit_seq = 0
        self._drain_seq = 0

    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """fn(actor, value) -> ObjectRef. With no free actor the call is
        queued and dispatched when a result is consumed (reference
        semantics: get_next frees the actor, which drains the queue)."""
        if not self._idle:
            self._backlog.append((fn, value))
            return
        actor = self._idle.pop()
        ref = fn(actor, value)
        self._inflight[ref] = (self._submit_seq, actor)
        self._ref_by_seq[self._submit_seq] = ref
        self._submit_seq += 1

    def _return_actor(self, actor: Any) -> None:
        self._idle.append(actor)
        if self._backlog:
            fn, value = self._backlog.popleft()
            self.submit(fn, value)

    def get_next(self, timeout: float = 300.0) -> Any:
        """Next result in SUBMISSION order."""
        if self._drain_seq >= self._submit_seq:
            raise StopIteration("no pending results")
        ref = self._ref_by_seq.pop(self._drain_seq)
        self._drain_seq += 1
        _, actor = self._inflight.pop(ref)
        try:
            return ray_tpu_torch.get(ref, timeout=timeout)
        finally:
            self._return_actor(actor)

    def get_next_unordered(self, timeout: float = 300.0) -> Any:
        """Next result in COMPLETION order."""
        if not self._inflight:
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(list(self._inflight),
                                num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        ref = ready[0]
        idx, actor = self._inflight.pop(ref)
        self._ref_by_seq.pop(idx, None)
        try:
            return ray_tpu_torch.get(ref, timeout=timeout)
        finally:
            self._return_actor(actor)

    def map(self, fn: Callable[[Any, Any], Any], values) -> List[Any]:
        """Submission-ordered map over values."""
        out = []
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            out.append(self.get_next())
        return out

    def map_unordered(self, fn: Callable[[Any, Any], Any], values):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def has_next(self) -> bool:
        return bool(self._inflight or self._backlog)

    def has_free(self) -> bool:
        return bool(self._idle)
