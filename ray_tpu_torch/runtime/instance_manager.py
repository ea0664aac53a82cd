"""Instance lifecycle state machine for autoscaler-owned nodes.

Role-equivalent to the reference's autoscaler-v2 InstanceManager
(reference: autoscaler/v2/instance_manager/instance_manager.py:29 +
instance_storage.py — every cloud launch becomes a declarative Instance
record whose transitions are versioned storage writes): a provider launch
is no longer a bare handle in a process-local list but an
``InstanceRecord`` that moves through

    REQUESTED -> ALLOCATED -> RUNNING -> DRAINING -> TERMINATED
         |           |            `----------------> DEAD
         |           `-> LAUNCH_FAILED
         `-> RUNNING (crash-window adoption: node registered while down)

with every transition (a) validated against the allowed-transition map,
(b) persisted through the head's KV table — which rides the head's
existing snapshot/restore path, so records survive BOTH autoscaler and
head restarts — and (c) journaled into the head's ClusterEventJournal
under the record's trace id, one id per instance, so
``python -m ray_tpu_torch events --follow`` replays a whole launch/drain storm
and `trace` can join it.

Crash consistency is write-ahead: the REQUESTED record (carrying the
node identity the daemon will register under) is persisted BEFORE the
provider call, and the provider's own ledger (LocalNodeProvider's ledger
file; a cloud provider's instance-list API) closes the residual window
between "provider created" and "ALLOCATED persisted". ``reconcile``
replays that state against the head's live node table after a restart:
records whose node registered while the manager was down are re-adopted
into RUNNING; REQUESTED/ALLOCATED records past the orphan grace whose
node never registered are terminated through the provider so no handle
is ever leaked — SIGKILLing the autoscaler between ``create_node`` and
node registration must converge to zero orphans (tier-1 asserted).

The port of ``ray_tpu/runtime/instance_manager.py``, with the same KV
prefix scheme (one key per instance under ``KV_PREFIX``) and the port's
fault injector. This module imports neither torch nor anything of the
JAX package: it runs inside the autoscaler daemon, which holds no card.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("ray_tpu_torch.instance_manager")

# ------------------------------------------------------------------ states

REQUESTED = "REQUESTED"          # record persisted; provider call imminent
ALLOCATED = "ALLOCATED"          # provider created (handle/metadata known)
RUNNING = "RUNNING"              # node daemon registered with the head
DRAINING = "DRAINING"            # scale-down victim: leaving, not yet gone
TERMINATED = "TERMINATED"        # released through the provider (terminal)
LAUNCH_FAILED = "LAUNCH_FAILED"  # died before ever registering (terminal)
DEAD = "DEAD"                    # died after RUNNING without a drain (terminal)

TERMINAL_STATES = frozenset({TERMINATED, LAUNCH_FAILED, DEAD})

#: the declarative transition map — anything not listed is a bug, not a
#: race (reference: instance_manager.py's get_transition checks). Every
#: live state may terminate (crash-reconcile can orphan-kill from any of
#: them) and REQUESTED may fail before a handle exists (provider raised).
_ALLOWED: Dict[str, frozenset] = {
    # REQUESTED -> RUNNING is the crash-window adoption: the ALLOCATED
    # persist never landed but the node registered anyway
    REQUESTED: frozenset({ALLOCATED, RUNNING, LAUNCH_FAILED, TERMINATED}),
    ALLOCATED: frozenset({RUNNING, LAUNCH_FAILED, TERMINATED}),
    RUNNING: frozenset({DRAINING, DEAD, TERMINATED}),
    DRAINING: frozenset({TERMINATED, DEAD}),
    TERMINATED: frozenset(),
    LAUNCH_FAILED: frozenset(),
    DEAD: frozenset(),
}

#: journal event type per entered state (the REQUESTED event is emitted
#: by ``request()``); kept 1:1 so a journal dump filtered by trace_id IS
#: the instance's transition history.
_EVENT_BY_STATE = {
    ALLOCATED: "instance_allocated",
    RUNNING: "instance_running",
    DRAINING: "instance_draining",
    TERMINATED: "instance_terminated",
    LAUNCH_FAILED: "node_launch_failed",
    DEAD: "instance_dead",
}


class InvalidTransition(RuntimeError):
    """A transition outside the allowed map — state-machine corruption."""


class InstanceRecord:
    """One autoscaler-owned instance. ``node_id`` doubles as the instance
    id: it is the identity the launched daemon registers under, chosen
    BEFORE the provider call so a crash between create and persist can
    still be reconciled by identity."""

    __slots__ = ("node_id", "node_type", "resources", "state", "trace_id",
                 "metadata", "created_wall", "updated_wall", "history",
                 "handle")

    def __init__(self, node_id: str, node_type: str,
                 resources: Dict[str, float], trace_id: str,
                 state: str = REQUESTED):
        self.node_id = node_id
        self.node_type = node_type
        self.resources = dict(resources)
        self.state = state
        self.trace_id = trace_id
        self.metadata: Dict[str, Any] = {}   # provider-side (pid, name...)
        self.created_wall = time.time()
        self.updated_wall = self.created_wall
        self.history: List[Tuple[str, float]] = [(state, self.created_wall)]
        # in-memory only (a Popen): lost across restarts —
        # the provider ledger + metadata stand in for it after one
        self.handle: Any = None

    @property
    def live(self) -> bool:
        return self.state not in TERMINAL_STATES

    @property
    def age_s(self) -> float:
        return time.time() - self.created_wall

    def to_dict(self) -> dict:
        """Persisted wire form (plain JSON-able types; no handle)."""
        return {"node_id": self.node_id, "node_type": self.node_type,
                "resources": dict(self.resources), "state": self.state,
                "trace_id": self.trace_id, "metadata": dict(self.metadata),
                "created_wall": self.created_wall,
                "updated_wall": self.updated_wall,
                "history": [[s, ts] for s, ts in self.history]}

    @classmethod
    def from_dict(cls, d: dict) -> "InstanceRecord":
        rec = cls(d["node_id"], d["node_type"], d.get("resources") or {},
                  d.get("trace_id", ""), state=d.get("state", REQUESTED))
        rec.metadata = dict(d.get("metadata") or {})
        rec.created_wall = float(d.get("created_wall", rec.created_wall))
        rec.updated_wall = float(d.get("updated_wall", rec.created_wall))
        rec.history = [(s, float(ts)) for s, ts in d.get("history") or
                       [[rec.state, rec.created_wall]]]
        return rec


# ------------------------------------------------------------------- stores

#: KV key prefix the persisted records live under — inside the head's KV
#: table, which the head's snapshot/restore path already makes durable
KV_PREFIX = "__rtpu/instance/"


class MemoryInstanceStore:
    """Dict-backed store for unit tests (same contract as the KV store)."""

    def __init__(self):
        self._d: Dict[str, dict] = {}

    def put(self, node_id: str, rec: dict) -> None:
        self._d[node_id] = dict(rec)

    def delete(self, node_id: str) -> None:
        self._d.pop(node_id, None)

    def load_all(self) -> Dict[str, dict]:
        return {k: dict(v) for k, v in self._d.items()}


class KvInstanceStore:
    """Records persisted through the head's KV table (kv_put / kv_get /
    kv_keys RPCs) — the head's existing persistence path; a head restart
    restores them from its snapshot, an autoscaler restart re-reads them
    over RPC. Store failures raise: a transition that could not be made
    durable must not be treated as committed."""

    def __init__(self, head_client):
        self.head = head_client

    def put(self, node_id: str, rec: dict) -> None:
        from ray_tpu_torch.util.fault_injector import fire
        fire("instance_store.put")
        self.head.call("kv_put", {"key": KV_PREFIX + node_id,
                                  "value": rec, "overwrite": True},
                       timeout=10)

    def delete(self, node_id: str) -> None:
        self.head.call("kv_del", {"key": KV_PREFIX + node_id}, timeout=10)

    def load_all(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for key in self.head.call("kv_keys", {"prefix": KV_PREFIX},
                                  timeout=10) or []:
            rec = self.head.call("kv_get", {"key": key}, timeout=10)
            if isinstance(rec, dict) and rec.get("node_id"):
                out[rec["node_id"]] = rec
        return out


# ------------------------------------------------------------------ manager

class InstanceManager:
    """Owns the record table and enforces persist-then-journal on every
    transition. ``journal(event_type, trace_id, **fields)`` is injected
    (the autoscaler routes it to the head's journal_record RPC); it is
    best-effort — journaling must never block a state change that is
    already durable."""

    def __init__(self, store, journal: Optional[Callable[..., Any]] = None):
        self.store = store
        self._journal = journal or (lambda *_a, **_k: None)
        self._lock = threading.Lock()
        self._records: Dict[str, InstanceRecord] = {}

    # ------------------------------------------------------------- access

    def get(self, node_id: str) -> Optional[InstanceRecord]:
        with self._lock:
            return self._records.get(node_id)

    def records(self, *states: str) -> List[InstanceRecord]:
        """Records in any of ``states`` (all records when none given)."""
        with self._lock:
            recs = list(self._records.values())
        if states:
            recs = [r for r in recs if r.state in states]
        return recs

    def live_counts(self) -> Dict[str, int]:
        """Per-type count of instances holding (or about to hold)
        capacity: REQUESTED/ALLOCATED/RUNNING. DRAINING is excluded — a
        draining node is on its way out and must not block a scale-up."""
        counts: Dict[str, int] = {}
        for rec in self.records(REQUESTED, ALLOCATED, RUNNING):
            counts[rec.node_type] = counts.get(rec.node_type, 0) + 1
        return counts

    # -------------------------------------------------------- transitions

    def request(self, node_type: str, resources: Dict[str, float],
                node_id: str, trace_id: str = "") -> InstanceRecord:
        """Write-ahead REQUESTED record: persisted (and journaled) BEFORE
        the provider call, so a crash mid-launch leaves a record to
        reconcile instead of an untracked cloud instance."""
        if not trace_id:
            from ray_tpu_torch.util import trace_context
            trace_id = trace_context.new_trace_id()
        rec = InstanceRecord(node_id, node_type, resources, trace_id)
        self.store.put(node_id, rec.to_dict())
        with self._lock:
            self._records[node_id] = rec
        self._emit("instance_requested", rec)
        return rec

    def transition(self, node_id: str, new_state: str,
                   metadata: Optional[Dict[str, Any]] = None,
                   **journal_fields) -> InstanceRecord:
        """Validated persist-then-journal state change. Terminal states
        delete the persisted key (the journal keeps the history; a
        tombstone would otherwise grow the KV table one entry per launch
        forever) but the in-memory record is kept for inspection."""
        with self._lock:
            rec = self._records.get(node_id)
            if rec is None:
                raise KeyError(f"unknown instance {node_id!r}")
            if new_state not in _ALLOWED[rec.state]:
                raise InvalidTransition(
                    f"instance {node_id[:12]}: {rec.state} -> {new_state} "
                    f"is not an allowed transition")
            prev = rec.state
            rec.state = new_state
            rec.updated_wall = time.time()
            rec.history.append((new_state, rec.updated_wall))
            if metadata:
                rec.metadata.update(metadata)
        if new_state in TERMINAL_STATES:
            self.store.delete(node_id)
        else:
            self.store.put(node_id, rec.to_dict())
        self._emit(_EVENT_BY_STATE[new_state], rec, prev_state=prev,
                   **journal_fields)
        return rec

    def _emit(self, event_type: str, rec: InstanceRecord,
              **fields) -> None:
        try:
            self._journal(event_type, trace_id=rec.trace_id,
                          node_id=rec.node_id, node_type=rec.node_type,
                          state=rec.state, **fields)
        except Exception:  # noqa: BLE001 — journaling is best-effort
            logger.debug("journal emit failed for %s", event_type)

    # ---------------------------------------------------------- reconcile

    def load(self) -> int:
        """Read persisted records (an earlier incarnation's) into memory;
        returns how many were restored. Existing in-memory records win —
        load() is for a fresh manager after a restart."""
        restored = 0
        for node_id, d in self.store.load_all().items():
            try:
                rec = InstanceRecord.from_dict(d)
            except Exception:  # noqa: BLE001 — torn/alien record
                logger.warning("discarding unreadable instance record %r",
                               node_id[:12])
                try:
                    self.store.delete(node_id)
                except Exception:  # noqa: BLE001
                    pass
                continue
            with self._lock:
                if node_id not in self._records:
                    self._records[node_id] = rec
                    restored += 1
        return restored

    def reconcile(self, registered: set,
                  provider_live: Optional[Dict[str, dict]] = None,
                  terminate: Optional[Callable[[InstanceRecord], None]]
                  = None, orphan_grace_s: float = 0.0) -> Dict[str, list]:
        """Converge restored records against the head's live node table.

        * REQUESTED/ALLOCATED whose node DID register while we were down
          -> adopt straight to RUNNING (journaled ``instance_adopted``
          detail on the transition).
        * REQUESTED/ALLOCATED whose node never registered and is older
          than ``orphan_grace_s`` -> terminate through the provider (the
          record's metadata / the provider ledger locates it without an
          in-memory handle) -> TERMINATED. Young ones are left pending —
          the normal adoption loop picks them up.
        * RUNNING whose node is gone -> DEAD.
        * DRAINING whose node is gone -> TERMINATED (the drain finished
          while we were down).
        * ``provider_live`` entries with NO record at all (the crash won
          the tiny create-vs-persist race) -> terminate, journaled as
          ``instance_unrecorded`` orphans.

        Idempotent: a second reconcile over converged state is a no-op,
        so a double restart journals no duplicate transitions.
        """
        now = time.time()
        actions: Dict[str, list] = {"adopted": [], "orphaned": [],
                                    "dead": [], "drained": [],
                                    "pending": [], "unrecorded": []}
        for rec in self.records():
            if rec.state in (REQUESTED, ALLOCATED):
                if rec.node_id in registered:
                    self.transition(rec.node_id, RUNNING,
                                    detail="adopted-after-restart")
                    actions["adopted"].append(rec.node_id)
                elif now - rec.created_wall >= orphan_grace_s:
                    if terminate is not None:
                        try:
                            terminate(rec)
                        except Exception:  # noqa: BLE001 — a failed
                            # orphan kill must not wedge reconcile; the
                            # next pass retries
                            logger.exception(
                                "orphan terminate failed for %s",
                                rec.node_id[:12])
                            actions["pending"].append(rec.node_id)
                            continue
                    self.transition(rec.node_id, TERMINATED,
                                    detail="orphaned-launch",
                                    age_s=round(now - rec.created_wall, 2))
                    actions["orphaned"].append(rec.node_id)
                else:
                    actions["pending"].append(rec.node_id)
            elif rec.state == RUNNING and rec.node_id not in registered:
                self.transition(rec.node_id, DEAD,
                                detail="missing-after-restart")
                actions["dead"].append(rec.node_id)
            elif rec.state == DRAINING and rec.node_id not in registered:
                self.transition(rec.node_id, TERMINATED,
                                detail="drain-finished-across-restart")
                actions["drained"].append(rec.node_id)
        if provider_live:
            with self._lock:
                known = set(self._records)
            for node_id, meta in provider_live.items():
                if node_id in known or node_id in registered:
                    continue
                # provider created it, no record ever landed: the record
                # write crashed mid-flight — still not a leak
                if terminate is not None:
                    ghost = InstanceRecord(node_id, "?", {}, "")
                    ghost.metadata = dict(meta or {})
                    try:
                        terminate(ghost)
                    except Exception:  # noqa: BLE001
                        logger.exception("unrecorded orphan terminate "
                                         "failed for %s", node_id[:12])
                        continue
                self._journal("instance_unrecorded", trace_id="",
                              node_id=node_id, detail="terminated")
                actions["unrecorded"].append(node_id)
        return actions
