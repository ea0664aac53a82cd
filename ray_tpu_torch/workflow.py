"""Durable workflows: DAG execution with storage-backed step memoization,
dynamic continuations, durable events, retries, and a status API.

Role-equivalent to the reference's Workflow subsystem (reference:
workflow/workflow_executor.py:32 execution loop, workflow_storage.py:
checkpoint keys, workflow/api.py: run/resume/list/cancel surface,
workflow/event_listener.py: wait_for_event). Redesigned around this
framework's DAG nodes instead of the reference's coroutine executor:

 - every DAG node is one step; a step's value is checkpointed the moment
   it completes, keyed by graph position, so re-running (or resume()) after
   a crash replays only unfinished steps;
 - a step may return ``continuation(sub_dag)`` — the sub-graph is executed
   in the parent's place with its own checkpoint namespace (the reference's
   dynamic workflows, workflow_executor.py:32 ``_deref`` recursion);
 - ``event(name)`` nodes block the workflow until ``signal()`` delivers a
   value; delivery is durable, so a crashed workflow resumes past events
   it already received (reference: event_listener.py EventListener);
 - storage is pluggable (reference: workflow_storage.py over filesystem/S3)
   — filesystem by default, cluster-KV optional.

The port of ``ray_tpu/workflow.py``, on the port's DAG nodes
(``ray_tpu_torch.dag``) and ``util/filesystem.py``. The checkpoint layout
is the JAX package's: the same keys (a step's key hashes its graph
position and its function's qualified name), ``meta.json`` as JSON, and
step values and events as cloudpickles, so a workflow's status, events
and steps of plain values (numbers, strings, numpy arrays) read the same
in either package; the stored graph is each package's own DAG. The
default root is ``ray_tpu_torch_workflows`` under the temporary
directory.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.dag import DAGNode

_DEFAULT_STORAGE = os.path.join(tempfile.gettempdir(),
                                "ray_tpu_torch_workflows")

RUNNING = "RUNNING"
COMPLETED = "COMPLETED"
FAILED = "FAILED"
CANCELLED = "CANCELLED"
RESUMABLE = "RESUMABLE"


class WorkflowError(RuntimeError):
    pass


class WorkflowCancelledError(WorkflowError):
    pass


# ---------------------------------------------------------------------------
# storage seam (reference: workflow_storage.py — put/get over opaque keys)


class WorkflowStorage:
    """Key/value durability for workflow state. Keys are
    ``<workflow_id>/<name>``; values are opaque bytes."""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        return self.get(key) is not None

    def list_ids(self) -> List[str]:
        raise NotImplementedError

    def delete_workflow(self, workflow_id: str) -> None:
        raise NotImplementedError


class FilesystemStorage(WorkflowStorage):
    """Default backend: one directory per workflow, routed through the
    shared :mod:`ray_tpu_torch.util.filesystem` seam (atomic puts, transient-
    error retries, ``storage.*`` fault points — the same durability
    contract train checkpoints and spill use). ``fs`` accepts any
    StorageFilesystem or a ``memory://name`` spec for tests."""

    def __init__(self, root: str = _DEFAULT_STORAGE, fs=None):
        from ray_tpu_torch.util.filesystem import storage_filesystem
        self.root = root
        self.fs = storage_filesystem(fs)

    def _path(self, key: str) -> str:
        wf, _, name = key.partition("/")
        return os.path.join(self.root, wf, name)

    def put(self, key: str, data: bytes) -> None:
        self.fs.put(self._path(key), data)

    def get(self, key: str) -> Optional[bytes]:
        try:
            return self.fs.get(self._path(key))
        except FileNotFoundError:
            return None

    def list_ids(self) -> List[str]:
        # a workflow exists iff its directory has at least one object
        # (object stores have no empty directories)
        return sorted(
            d for d in self.fs.list(self.root)
            if self.fs.list(os.path.join(self.root, d)))

    def delete_workflow(self, workflow_id: str) -> None:
        self.fs.delete(os.path.join(self.root, workflow_id))


class KVStorage(WorkflowStorage):
    """Cluster-KV backend: workflow state lives in the head's KV table and
    inherits its snapshot durability (head restart keeps workflows
    resumable cluster-wide without a shared filesystem)."""

    PREFIX = "__wf__/"

    @staticmethod
    def _kv():
        from ray_tpu_torch.core.worker import require_connected
        return require_connected().backend

    def put(self, key: str, data: bytes) -> None:
        self._kv().kv_put(self.PREFIX + key, data)

    def get(self, key: str) -> Optional[bytes]:
        return self._kv().kv_get(self.PREFIX + key)

    def list_ids(self) -> List[str]:
        ids = set()
        for k in self._kv().kv_keys(self.PREFIX):
            rest = k[len(self.PREFIX):]
            ids.add(rest.partition("/")[0])
        return sorted(ids)

    def delete_workflow(self, workflow_id: str) -> None:
        kv = self._kv()
        for k in kv.kv_keys(f"{self.PREFIX}{workflow_id}/"):
            kv.kv_del(k)


def _storage_for(storage) -> WorkflowStorage:
    if storage is None:
        return FilesystemStorage()
    if isinstance(storage, WorkflowStorage):
        return storage
    if storage == "kv":
        return KVStorage()
    return FilesystemStorage(str(storage))


# ---------------------------------------------------------------------------
# user-facing step markers


class _Continuation:
    """Returned BY a step to replace itself with a sub-graph (the
    reference's dynamic workflows)."""

    __slots__ = ("dag",)

    def __init__(self, dag: DAGNode):
        self.dag = dag


def continuation(dag: DAGNode) -> _Continuation:
    if not isinstance(dag, DAGNode):
        raise TypeError("continuation() takes a DAG node (fn.bind(...))")
    return _Continuation(dag)


class _EventNode:
    """A leaf that blocks the workflow until signal() delivers a value."""

    __slots__ = ("name", "timeout_s")

    def __init__(self, name: str, timeout_s: Optional[float]):
        self.name = name
        self.timeout_s = timeout_s


def event(name: str, timeout_s: Optional[float] = None) -> _EventNode:
    """Use as a DAG argument: ``process.bind(workflow.event("approved"))``.
    The step runs once ``signal(workflow_id, "approved", value)`` fires;
    delivery is durable (reference: event_listener.py)."""
    return _EventNode(name, timeout_s)


def signal(workflow_id: str, name: str, value: Any = None,
           storage=None) -> None:
    """Deliver an event to a (possibly not yet running) workflow."""
    st = _storage_for(storage)
    st.put(f"{workflow_id}/event_{name}",
           cloudpickle.dumps(value, protocol=5))


# ---------------------------------------------------------------------------
# executor


def _step_key(node: DAGNode, path: str) -> str:
    """Stable step identity: graph position + function name (argument
    VALUES are not hashed — the graph structure is the identity, matching
    the reference's step-id-from-DAG-position)."""
    name = getattr(node._fn, "__qualname__", None) or getattr(
        getattr(node._fn, "underlying_function", None), "__qualname__",
        "fn")
    return hashlib.sha1(f"{path}:{name}".encode()).hexdigest()[:16]


class _WorkflowRun:
    def __init__(self, workflow_id: str, storage: WorkflowStorage,
                 step_timeout_s: float, max_step_retries: int):
        self.workflow_id = workflow_id
        self.storage = storage
        self.step_timeout_s = step_timeout_s
        self.max_step_retries = max_step_retries
        self.executed: Dict[int, Any] = {}
        self.steps_run = 0
        self.steps_replayed = 0

    # -- metadata --

    def _meta(self) -> dict:
        raw = self.storage.get(f"{self.workflow_id}/meta.json")
        return json.loads(raw) if raw else {}

    def set_status(self, status: str, **extra) -> None:
        meta = self._meta()
        meta.update({"status": status, "updated_at": time.time(), **extra})
        meta.setdefault("created_at", time.time())
        self.storage.put(f"{self.workflow_id}/meta.json",
                         json.dumps(meta).encode())

    def _check_cancel(self) -> None:
        if self.storage.exists(f"{self.workflow_id}/cancel"):
            raise WorkflowCancelledError(self.workflow_id)

    # -- execution --

    def run_node(self, node: Any, path: str) -> Any:
        if isinstance(node, _EventNode):
            return self._wait_event(node)
        if not isinstance(node, DAGNode):
            return node
        if id(node) in self.executed:
            return self.executed[id(node)]
        key = _step_key(node, path)
        ckpt = f"{self.workflow_id}/step_{key}"
        raw = self.storage.get(ckpt)
        if raw is not None:
            value = cloudpickle.loads(raw)
            self.steps_replayed += 1
        else:
            self._check_cancel()
            args = [self.run_node(a, f"{path}.a{i}")
                    for i, a in enumerate(node._args)]
            kwargs = {k: self.run_node(v, f"{path}.k{k}")
                      for k, v in node._kwargs.items()}
            self._check_cancel()
            value = self._run_step(node, args, kwargs)
            if isinstance(value, _Continuation):
                # dynamic sub-graph replaces this step; its steps
                # checkpoint under the parent's namespace (reference:
                # workflow_executor.py continuation deref)
                value = self.run_node(value.dag, f"{path}.c")
            self.storage.put(ckpt, cloudpickle.dumps(value, protocol=5))
            self.steps_run += 1
        self.executed[id(node)] = value
        return value

    def _run_step(self, node: DAGNode, args: list, kwargs: dict) -> Any:
        attempts = 0
        while True:
            attempts += 1
            try:
                return ray_tpu_torch.get(node._fn.remote(*args, **kwargs),
                                         timeout=self.step_timeout_s)
            except WorkflowCancelledError:
                raise
            except Exception:  # noqa: BLE001 — step failure
                if attempts > self.max_step_retries:
                    raise
                time.sleep(min(2.0 ** attempts * 0.1, 5.0))

    def _wait_event(self, ev: _EventNode) -> Any:
        key = f"{self.workflow_id}/event_{ev.name}"
        deadline = (None if ev.timeout_s is None
                    else time.monotonic() + ev.timeout_s)
        while True:
            raw = self.storage.get(key)
            if raw is not None:
                return cloudpickle.loads(raw)
            self._check_cancel()
            if deadline is not None and time.monotonic() >= deadline:
                raise WorkflowError(
                    f"event {ev.name!r} not delivered within "
                    f"{ev.timeout_s}s")
            time.sleep(0.05)


def run(dag: DAGNode, *, workflow_id: str,
        storage=None,
        step_timeout_s: float = 24 * 3600.0,
        max_step_retries: int = 0) -> Any:
    """Execute (or resume) a workflow; returns the final value.

    Steps run as cluster tasks; each completed step's value persists
    before the next starts, so a crash loses at most the in-flight step.
    ``step_timeout_s`` bounds one step (default a day — training-scale);
    ``max_step_retries`` re-runs a FAILED step that many times before the
    whole workflow fails (resumable where it stopped).
    """
    st = _storage_for(storage)
    wf = _WorkflowRun(workflow_id, st, step_timeout_s, max_step_retries)
    # persist the graph so resume(workflow_id) works without the caller
    # re-supplying it (reference: workflow_storage save_workflow_prerequisites)
    if not st.exists(f"{workflow_id}/dag"):
        st.put(f"{workflow_id}/dag", cloudpickle.dumps(
            {"dag": dag, "step_timeout_s": step_timeout_s,
             "max_step_retries": max_step_retries}, protocol=5))
    wf.set_status(RUNNING)
    try:
        result = wf.run_node(dag, "root")
    except WorkflowCancelledError:
        wf.set_status(CANCELLED)
        raise
    except BaseException as e:
        wf.set_status(RESUMABLE, error=repr(e))
        raise
    wf.set_status(COMPLETED)
    run.last_stats = {"steps_run": wf.steps_run,
                      "steps_replayed": wf.steps_replayed}
    return result


run.last_stats = {}


def run_async(dag: DAGNode, *, workflow_id: str, storage=None,
              **opts):
    """Run the workflow driver itself as a cluster task; returns an
    ObjectRef of the final value (reference: api.run's async path)."""
    blob = cloudpickle.dumps(
        {"dag": dag, "workflow_id": workflow_id,
         "storage_root": getattr(_storage_for(storage), "root", None),
         "opts": opts}, protocol=5)

    @ray_tpu_torch.remote
    def _workflow_driver(payload: bytes):
        spec = cloudpickle.loads(payload)
        st = (FilesystemStorage(spec["storage_root"])
              if spec["storage_root"] else KVStorage())
        return run(spec["dag"], workflow_id=spec["workflow_id"],
                   storage=st, **spec["opts"])

    return _workflow_driver.remote(blob)


def resume(workflow_id: str, storage=None) -> Any:
    """Re-run a stored workflow: completed steps replay from checkpoints,
    the rest execute (reference: api.resume)."""
    st = _storage_for(storage)
    raw = st.get(f"{workflow_id}/dag")
    if raw is None:
        raise WorkflowError(f"no stored workflow {workflow_id!r}")
    spec = cloudpickle.loads(raw)
    return run(spec["dag"], workflow_id=workflow_id, storage=st,
               step_timeout_s=spec.get("step_timeout_s", 24 * 3600.0),
               max_step_retries=spec.get("max_step_retries", 0))


def cancel(workflow_id: str, storage=None) -> None:
    """Request cancellation: the run stops before its next step
    (reference: api.cancel — in-flight steps are not interrupted)."""
    _storage_for(storage).put(f"{workflow_id}/cancel", b"1")


def get_status(workflow_id: str, storage=None) -> Optional[str]:
    raw = _storage_for(storage).get(f"{workflow_id}/meta.json")
    return json.loads(raw).get("status") if raw else None


def list_all(storage=None) -> List[dict]:
    """[{workflow_id, status, created_at, updated_at}] for every stored
    workflow (reference: api.list_all)."""
    st = _storage_for(storage)
    out = []
    for wf in st.list_ids():
        raw = st.get(f"{wf}/meta.json")
        meta = json.loads(raw) if raw else {}
        out.append({"workflow_id": wf,
                    "status": meta.get("status"),
                    "created_at": meta.get("created_at"),
                    "updated_at": meta.get("updated_at")})
    return out


def delete(workflow_id: str, storage: Optional[str] = None) -> None:
    _storage_for(storage).delete_workflow(workflow_id)
