"""Programmatic state API (reference: python/ray/util/state/api.py:110 —
list_actors at :784, list_nodes, etc.). All queries aggregate through the
head's state_dump, the single source the CLI also uses. The port of
``ray_tpu/util/state.py``."""

from __future__ import annotations

from typing import Dict, List

from ray_tpu_torch.core.worker import require_connected


def _dump(task_limit: int = 200) -> dict:
    worker = require_connected()
    backend = worker.backend
    if hasattr(backend, "state_dump"):
        return backend.state_dump(task_limit=task_limit)
    # local mode: synthesize from the in-process backend
    return {
        "nodes": [{"node_id": "local", "alive": True,
                   "resources": backend.cluster_resources(),
                   "address": "local"}],
        "actors": [{"actor_id": aid.hex(), "class": a.spec.name,
                    "state": "DEAD" if a.dead else "ALIVE",
                    "node_id": "local", "name": a.spec.registered_name,
                    "restarts": 0, "reason": a.death_reason}
                   for aid, a in backend.actors.items()],
        "leases": 0,
        "placement_groups": [],
        "tasks": [],
        "objects": [{"owner": "local", "node": "local", "role": "driver",
                     "tracked": worker.refcounter.num_tracked(),
                     "sample": []}],
        # shape parity with the cluster head's state_dump: local mode has
        # no shm arena (everything lives in the in-process store) and no
        # journal, so both accounting surfaces are legitimately empty
        "objects_dir": [],
        "events": {"recorded": 0, "kept": 0},
    }


def list_nodes() -> List[Dict]:
    return _dump()["nodes"]


def list_actors(state: str = "") -> List[Dict]:
    actors = _dump()["actors"]
    if state:
        actors = [a for a in actors if a["state"] == state]
    return actors


def list_placement_groups() -> List[Dict]:
    return _dump()["placement_groups"]


def list_tasks(limit: int = 200) -> List[Dict]:
    """Recent task spans (name, kind, worker, node, timing, ok) — the
    reference's `ray list tasks` surface (util/state/api.py:1011), served
    from the head's task-event buffer."""
    return _dump(task_limit=limit).get("tasks", [])[-limit:]


def list_objects() -> List[Dict]:
    """Per-object directory rows (object_id, size, role primary/
    secondary/spilled, owner, age, pin counts, node) — the reference's
    `ray list objects` under the ownership model: owners are the
    authority, so the head aggregates the directory each owner ships in
    its telemetry report. Falls back to the coarser per-owner summaries
    when the accounting directory is empty (object_accounting off)."""
    d = _dump()
    return d.get("objects_dir") or d.get("objects", [])


def summarize() -> Dict:
    d = _dump()
    events = d.get("events") or {}
    return {
        "nodes_alive": sum(1 for n in d["nodes"] if n["alive"]),
        "nodes_total": len(d["nodes"]),
        "actors": len(d["actors"]),
        "actors_alive": sum(1 for a in d["actors"] if a["state"] == "ALIVE"),
        "placement_groups": len(d["placement_groups"]),
        "active_leases": d["leases"],
        "tasks": len(d.get("tasks", [])),
        "objects": sum(int(o.get("tracked", 0))
                       for o in d.get("objects", [])),
        "objects_in_directory": len(d.get("objects_dir", [])),
        "events_recorded": int(events.get("recorded", 0)),
        "events_kept": int(events.get("kept", 0)),
    }
