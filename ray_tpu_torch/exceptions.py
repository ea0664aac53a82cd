"""User-facing exception hierarchy.

Mirrors the reference's error taxonomy (reference: python/ray/exceptions.py):
task errors wrap the remote traceback and re-raise at `get()`; actor errors
distinguish death-in-flight from dead-at-submit; system errors cover object
loss, OOM kills and node failure.
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception remotely; re-raised on get().

    Carries the remote traceback text so the user sees the real failure site.
    """

    def __init__(self, cause_cls_name: str, cause_repr: str, remote_tb: str, cause=None):
        self.cause_cls_name = cause_cls_name
        self.cause_repr = cause_repr
        self.remote_tb = remote_tb
        self.cause = cause
        super().__init__(f"{cause_cls_name}: {cause_repr}\n\nRemote traceback:\n{remote_tb}")

    @classmethod
    def from_exception(cls, exc: BaseException) -> "TaskError":
        return cls(
            type(exc).__name__,
            repr(exc),
            "".join(traceback.format_exception(type(exc), exc, exc.__traceback__)),
            cause=exc,
        )

    def __reduce__(self):
        # cause may be unpicklable (it crossed a process already); drop it.
        return (TaskError,
                (self.cause_cls_name, self.cause_repr, self.remote_tb))


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    """The actor is dead (creation failed, crashed past max_restarts, or killed)."""

    def __init__(self, actor_id_hex: str = "", reason: str = ""):
        self.actor_id_hex = actor_id_hex
        self.reason = reason
        super().__init__(f"actor {actor_id_hex} died: {reason}")

    def __reduce__(self):
        return (ActorDiedError, (self.actor_id_hex, self.reason))


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (restarting); call may be retried."""


class ObjectLostError(RayTpuError):
    """Object was evicted/lost and could not be reconstructed from lineage."""

    def __init__(self, object_id_hex: str = "", reason: str = ""):
        self.object_id_hex = object_id_hex
        self.reason = reason
        super().__init__(f"object {object_id_hex} lost: {reason}")

    def __reduce__(self):
        return (ObjectLostError, (self.object_id_hex, self.reason))


class ObjectStoreFullError(RayTpuError):
    """Shared-memory arena is full and eviction could not make room."""


class OutOfMemoryError(RayTpuError):
    """Worker killed by the memory monitor."""


class NodeDiedError(RayTpuError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    """ray_tpu.get(timeout=...) expired."""


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id_hex: str = ""):
        self.task_id_hex = task_id_hex
        super().__init__(f"task {task_id_hex} was cancelled")

    def __reduce__(self):
        return (TaskCancelledError, (self.task_id_hex,))


class RuntimeEnvSetupError(RayTpuError):
    """Per-task/actor runtime environment failed to materialize."""


class PlacementGroupUnschedulableError(RayTpuError):
    """Bundles cannot fit the cluster under the requested strategy."""
