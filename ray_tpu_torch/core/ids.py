"""Binary identifiers for jobs, tasks, actors, objects and nodes.

Design follows the reference's ID scheme (reference: src/ray/common/id.h:1,
design_docs/id_specification.md) — fixed-width binary IDs with structural
embedding so ownership and provenance can be recovered from the ID alone:

  JobID    :  4 bytes
  ActorID  : 16 bytes = JobID(4) + unique(12)
  TaskID   : 24 bytes = ActorID(16) + unique(8)   (actor tasks embed actor id;
             normal tasks embed a nil actor id's job prefix)
  ObjectID : 28 bytes = TaskID(24) + index(4)     (return index or put index)
  NodeID   : 16 bytes random
  WorkerID : 16 bytes random
  PlacementGroupID : 16 bytes = JobID(4) + unique(12)

All IDs are immutable, hashable, msgpack-serializable via .binary().
"""

from __future__ import annotations

import os
import threading

JOB_ID_SIZE = 4
ACTOR_ID_SIZE = 16
TASK_ID_SIZE = 24
OBJECT_ID_SIZE = 28
NODE_ID_SIZE = 16
WORKER_ID_SIZE = 16
PLACEMENT_GROUP_ID_SIZE = 16

# Put objects use indices counting down from 2**31; return objects count up
# from 1 (index 0 reserved for the actor creation dummy object).
_PUT_INDEX_BASE = 1 << 31


class BaseID:
    SIZE = 0
    __slots__ = ("_binary", "_hash")

    def __init__(self, binary: bytes):
        if not isinstance(binary, bytes) or len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, "
                f"got {len(binary) if isinstance(binary, bytes) else type(binary)}"
            )
        self._binary = binary
        self._hash = hash((type(self).__name__, binary))

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    def binary(self) -> bytes:
        return self._binary

    def hex(self) -> str:
        return self._binary.hex()

    def is_nil(self) -> bool:
        return self._binary == b"\x00" * self.SIZE

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._binary == self._binary

    def __lt__(self, other):
        return self._binary < other._binary

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._binary,))


class JobID(BaseID):
    SIZE = JOB_ID_SIZE

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(JOB_ID_SIZE, "little"))

    def int_value(self) -> int:
        return int.from_bytes(self._binary, "little")


class NodeID(BaseID):
    SIZE = NODE_ID_SIZE


class WorkerID(BaseID):
    SIZE = WORKER_ID_SIZE


class ActorID(BaseID):
    SIZE = ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.binary() + os.urandom(ACTOR_ID_SIZE - JOB_ID_SIZE))

    def job_id(self) -> JobID:
        return JobID(self._binary[:JOB_ID_SIZE])


class TaskID(BaseID):
    SIZE = TASK_ID_SIZE

    @classmethod
    def for_normal_task(cls, job_id: JobID) -> "TaskID":
        prefix = job_id.binary() + b"\x00" * (ACTOR_ID_SIZE - JOB_ID_SIZE)
        return cls(prefix + os.urandom(TASK_ID_SIZE - ACTOR_ID_SIZE))

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(actor_id.binary() + os.urandom(TASK_ID_SIZE - ACTOR_ID_SIZE))

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        """Deterministic creation-task id: actor id + zeros."""
        return cls(actor_id.binary() + b"\xff" * (TASK_ID_SIZE - ACTOR_ID_SIZE))

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        prefix = job_id.binary() + b"\x00" * (ACTOR_ID_SIZE - JOB_ID_SIZE)
        return cls(prefix + b"\x00" * (TASK_ID_SIZE - ACTOR_ID_SIZE))

    def actor_id(self) -> ActorID:
        return ActorID(self._binary[:ACTOR_ID_SIZE])

    def job_id(self) -> JobID:
        return JobID(self._binary[:JOB_ID_SIZE])


class ObjectID(BaseID):
    SIZE = OBJECT_ID_SIZE

    @classmethod
    def for_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        idx = _PUT_INDEX_BASE + put_index
        return cls(task_id.binary() + idx.to_bytes(4, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._binary[:TASK_ID_SIZE])

    def job_id(self) -> JobID:
        return JobID(self._binary[:JOB_ID_SIZE])

    def index(self) -> int:
        return int.from_bytes(self._binary[TASK_ID_SIZE:], "little")

    def is_put(self) -> bool:
        return self.index() >= _PUT_INDEX_BASE


class PlacementGroupID(BaseID):
    SIZE = PLACEMENT_GROUP_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(job_id.binary() + os.urandom(cls.SIZE - JOB_ID_SIZE))


class _Counter:
    """Thread-safe monotonically increasing counter."""

    def __init__(self, start: int = 0):
        self._value = start
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value
