"""Shm channel rings: fixed-capacity SPSC queues over the node's shm store.

The port of ``ray_tpu/runtime/channel.py``, its values serialised by the
port's ``core/serialization.py`` (a tensor crosses as host memory and
arrives as a CPU tensor) and its slot ids in a namespace of their own
(``rtpt-chan``). Role-equivalent to the reference's compiled-graph
channels (reference: python/ray/experimental/channel/ — mutable plasma
buffers + semaphores moving aDAG intermediates without tasks).
Redesigned over this runtime's existing arena (core/_native ShmStore): a
channel is a ring of `capacity` slot object-ids; the writer
creates+seals slot (seq % capacity), the reader polls contains(), reads,
and DELETES the slot — deletion is the backpressure signal that frees
the slot for lap seq+capacity. Same-node processes share the arena, so a
hop costs serialize + two native store calls + one poll, no RPC and no
scheduler.

Polling is adaptive: a short spin (native contains() is ~1µs) catches
the common in-flight case, then exponential sleep up to 1ms bounds idle
CPU on small hosts.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Optional

from ray_tpu_torch.core import serialization


class ChannelClosed(Exception):
    """The peer tore the channel down (sentinel received)."""


_STOP = b"\x00rtpt-channel-stop"


def _slot_id(name: str, slot: int) -> bytes:
    return hashlib.sha256(f"rtpt-chan:{name}:{slot}".encode()).digest()[:28]


class ShmChannel:
    """Single-producer single-consumer ring; one side writes, one reads.

    Both ends attach by (name, capacity) against the SAME node store —
    create one end with `writer=True` in the producing process and
    `writer=False` in the consuming process.
    """

    def __init__(self, store, name: str, capacity: int = 8):
        self.store = store
        self.name = name
        self.capacity = capacity
        self._seq = 0  # next slot to write (writer) / read (reader)

    # ------------------------------------------------------------- writer

    def put(self, value: Any, timeout: Optional[float] = None) -> None:
        payload = serialization.serialize(value).to_bytes()
        self.put_bytes(payload, timeout)

    def put_bytes(self, payload: bytes, timeout: Optional[float] = None
                  ) -> None:
        slot = _slot_id(self.name, self._seq % self.capacity)
        self._wait(lambda: not self.store.contains(slot), timeout,
                   "channel full (reader gone?)")
        self._write(slot, payload)

    def try_put(self, value: Any) -> bool:
        """Non-blocking put; False when the ring slot is still occupied
        (lets a single-threaded producer interleave result draining
        instead of deadlocking on a full pipeline)."""
        slot = _slot_id(self.name, self._seq % self.capacity)
        if self.store.contains(slot):
            return False
        self._write(slot, serialization.serialize(value).to_bytes())
        return True

    def _write(self, slot: bytes, payload: bytes) -> None:
        self.store.put(slot, payload)
        # drop the creator pin: the reader's delete must actually reclaim
        # the slot, or the ring jams on the first lap
        self.store.release(slot)
        self._seq += 1

    def close(self, timeout: Optional[float] = 5.0) -> bool:
        """Send the stop sentinel; the reader raises ChannelClosed.
        Returns False when the ring stayed full past the timeout (the
        sentinel was NOT sent — caller must unjam and retry, or the
        reader loop lives forever)."""
        try:
            self.put_bytes(_STOP, timeout)
            return True
        except TimeoutError:
            return False

    # ------------------------------------------------------------- reader

    def get(self, timeout: Optional[float] = None) -> Any:
        slot = _slot_id(self.name, self._seq % self.capacity)
        self._wait(lambda: self.store.contains(slot), timeout,
                   "channel empty (writer gone?)")
        view = self.store.get(slot)
        try:
            payload = bytes(view)
        finally:
            self.store.release(slot)
        self.store.delete(slot)  # frees the slot: writer backpressure
        self._seq += 1
        if payload == _STOP:
            raise ChannelClosed(self.name)
        return serialization.deserialize(payload)

    # ------------------------------------------------------------- common

    def drain(self) -> None:
        """Best-effort slot cleanup (teardown after a dead peer)."""
        for i in range(self.capacity):
            self.store.delete(_slot_id(self.name, i))

    @staticmethod
    def _wait(ready, timeout: Optional[float], what: str) -> None:
        # spin first: the native contains() costs ~1µs and in-flight hops
        # resolve in tens of µs; then back off to bound idle CPU
        for _ in range(200):
            if ready():
                return
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 50e-6
        while True:
            if ready():
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(what)
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)
