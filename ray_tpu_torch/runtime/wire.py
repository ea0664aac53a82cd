"""Wire form of task/actor specs for cross-process submission.

Role-equivalent to the reference's protobuf TaskSpec (reference:
src/ray/protobuf/common.proto via src/ray/common/task/task_spec.h): the
driver-side spec is flattened into a plain dict whose argument values are
pre-serialized with the framework serializer (core/serialization.py) so that

 - nested ObjectRefs inside argument values are discovered and pinned by the
   owner until the task's reply (the reference's inlined-arg borrow
   accounting, transport/dependency_resolver.h), and
 - the executing worker deserializes values through the same path used by
   the object store, registering borrows for refs it retains.

Functions ship by content hash: the pickled function is exported once to the
head KV (reference: python/ray/_private/function_manager.py export path) and
workers cache by key.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Dict, List, Tuple

import cloudpickle

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.ids import ActorID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.task_spec import ActorCreationSpec, TaskArg, TaskSpec
from ray_tpu_torch.util import trace_context


def export_function(fn: Any) -> Tuple[str, bytes]:
    """Pickle a function/class; key is the content hash (dedup per job)."""
    blob = cloudpickle.dumps(fn)
    return f"fn:{hashlib.sha1(blob).hexdigest()}", blob


def _args_to_wire(args: List[TaskArg]) -> Tuple[List[dict], list]:
    out = []
    contained = []
    for a in args:
        if a.is_ref:
            out.append({"ref": (a.object_id.binary(), a.owner.binary())})
        else:
            so = serialization.serialize(a.value)
            contained.extend(so.contained_refs)
            out.append({"inline": so.to_bytes()})
    return out, contained


def task_to_wire(spec: TaskSpec, function_key: str = "") -> Tuple[dict, list]:
    """Returns (payload, contained_refs). Caller pins contained_refs until
    the push reply arrives."""
    args, contained = _args_to_wire(spec.args)
    kw = serialization.serialize(spec.kwargs)
    contained.extend(kw.contained_refs)
    payload = {
        "task_id": spec.task_id.binary(),
        "name": spec.name,
        "function_key": function_key,
        "args": args,
        "kwargs": kw.to_bytes(),
        "num_returns": spec.num_returns,
        "streaming": spec.streaming,
        "resources": spec.resources,
        "max_retries": spec.max_retries,
        "retry_exceptions": spec.retry_exceptions,
        "owner": spec.owner.binary() if spec.owner else b"",
        "actor_id": spec.actor_id.binary() if spec.actor_id else None,
        "method_name": spec.method_name,
        "seq_no": spec.seq_no,
        # scheduler-phase anchor: lets the worker separate queueing delay
        # (submit → start) from execution in its recorded spans
        "submit_ts": time.time(),
    }
    # trace_id/parent_span_id/span_id: the child joins the submitter's
    # ambient trace (util/trace_context). Receivers read these with
    # .get(), so frames from a peer without them stay accepted.
    trace_context.stamp(payload)
    return payload, contained


def task_from_wire(p: dict) -> TaskSpec:
    args = []
    for a in p["args"]:
        if "ref" in a:
            oid, owner = a["ref"]
            args.append(TaskArg(is_ref=True, object_id=ObjectID(oid),
                                owner=WorkerID(owner)))
        else:
            args.append(TaskArg(is_ref=False, value=a["inline"]))
    return TaskSpec(
        task_id=TaskID(p["task_id"]),
        name=p["name"],
        function_key=p["function_key"].encode() if p["function_key"] else None,
        args=args,
        kwargs=p["kwargs"],  # serialized blob; executor deserializes
        num_returns=p["num_returns"],
        streaming=p.get("streaming", False),
        resources=p["resources"],
        max_retries=p["max_retries"],
        retry_exceptions=p["retry_exceptions"],
        owner=WorkerID(p["owner"]) if p["owner"] else None,
        actor_id=ActorID(p["actor_id"]) if p["actor_id"] else None,
        method_name=p["method_name"],
        seq_no=p["seq_no"],
    )


def lease_sig(resources) -> int:
    """Stable u64 signature of a plain resource shape — the key of the
    head's native lease pool (transport.cc FastLease). Head and clients
    must compute it identically; only pg-less, default-policy,
    default-runtime-env shapes are pooled."""
    import hashlib
    items = ",".join(f"{k}={float(resources[k]):.6f}"
                     for k in sorted(resources))
    return int.from_bytes(
        hashlib.blake2b(items.encode(), digest_size=8).digest(), "little")


def actor_to_wire(spec: ActorCreationSpec) -> Tuple[dict, list]:
    args, contained = _args_to_wire(spec.args)
    kw = serialization.serialize(spec.kwargs)
    contained.extend(kw.contained_refs)
    payload = {
        "actor_id": spec.actor_id.binary(),
        "name": spec.name,
        "registered_name": spec.registered_name,
        "namespace": spec.namespace,
        "cls_bytes": cloudpickle.dumps(spec.cls),
        "args": args,
        "kwargs": kw.to_bytes(),
        "resources": spec.resources,
        "max_restarts": spec.max_restarts,
        "max_task_retries": spec.max_task_retries,
        "max_concurrency": spec.max_concurrency,
        "concurrency_groups": dict(spec.concurrency_groups),
        "method_groups": dict(spec.method_groups),
        "owner": spec.owner.binary() if spec.owner else b"",
    }
    return payload, contained
