"""Head service — the global control plane (GCS role).

Role-equivalent to the reference's GcsServer (reference:
src/ray/gcs/gcs_server/gcs_server.h:89) with its managers collapsed into one
process: node membership (gcs_node_manager.h:45), actor directory + restart
orchestration (gcs_actor_manager.h:324, RestartActor at
gcs_actor_manager.cc:413), internal KV (gcs_kv_manager.h), health checks
(gcs_health_check_manager.h:45), and cluster-level scheduling decisions
(delegated to the C++ ClusterState, the role of
raylet/scheduling/cluster_resource_scheduler.h:44 — here centralized since
lease accounting lives on the head, not gossiped).

Leases: a client asks the head for (node, worker) to run a resource shape;
the head acquires resources, asks the node daemon to pop a worker from its
pool, and hands back the worker address. The client pushes tasks directly
to the worker (the reference's lease + direct PushTask design,
transport/normal_task_submitter.h:74) and releases the lease when idle.
"""

from __future__ import annotations

import collections
import json
import os
import pickle
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core import config as config_mod
from ray_tpu_torch.core._native import (POLICY_HYBRID, POLICY_NODE_AFFINITY,
                                  POLICY_SPREAD, ClusterState)
from ray_tpu_torch.runtime import wire
from ray_tpu_torch.runtime.protocol import ClientPool, RpcError, RpcServer

# actor states (reference: gcs.proto ActorTableData.ActorState)
PENDING = "PENDING"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"

_POLICY_BY_NAME = {
    "hybrid": POLICY_HYBRID,
    "spread": POLICY_SPREAD,
    "node_affinity": POLICY_NODE_AFFINITY,
}


def _bundle_fits(pg: dict, idx: int, resources: Dict[str, float]) -> bool:
    """Caller holds the head lock. True if `resources` fit what remains of
    bundle `idx` after current draws."""
    bundle = pg["bundles"][idx]
    used = pg.setdefault("used", [dict() for _ in pg["bundles"]])[idx]
    return all(used.get(k, 0.0) + v <= bundle.get(k, 0.0) + 1e-9
               for k, v in resources.items())


def _bundle_draw(pg: dict, idx: int, resources: Dict[str, float]) -> None:
    used = pg.setdefault("used", [dict() for _ in pg["bundles"]])[idx]
    for k, v in resources.items():
        used[k] = used.get(k, 0.0) + v


class _KvStore:
    """Head internal KV table (reference: GcsInternalKVManager,
    src/ray/gcs/gcs_server/gcs_kv_manager.h — a C++ KV service the Python
    layer also reads).

    Plain dict until the RPC server exists; once the native transport's
    listener fast-path is enabled the table LIVES inside the C event loop
    (src/transport.cc FastKV): client kv/ping frames are answered without
    entering Python at all, and this adapter becomes the head-side
    accessor over the same map. Values are pickled so str/bytes/objects
    round-trip identically through both paths.
    """

    def __init__(self):
        self._dict: Optional[Dict[str, Any]] = {}
        self._server = None
        self._mutations = 0  # dict-mode mutation counter (dirty tracking)
        # dict-mode check-and-set atomicity (handlers run on a thread
        # pool); the native store has its own C-side mutex
        self._dict_lock = threading.Lock()

    def attach_native(self, server, incarnation: int) -> bool:
        if not server.enable_kv_fastpath(incarnation):
            return False
        # migrate under the dict lock: the RPC server is ALREADY serving,
        # so a pickle-path kv_put can race this loop (reconnecting clients
        # land the moment the listener is up). Writers that grab the lock
        # after us see _server set and go native; writers that held it
        # before us finished their dict write before we copied.
        with self._dict_lock:
            for k, v in self._dict.items():  # migrate snapshot-restored keys
                server.kv_fast_put(k.encode(), pickle.dumps(v, protocol=5))
            self._server = server
            self._dict = None
        return True

    @property
    def native(self) -> bool:
        return self._server is not None

    def put(self, key: str, value: Any, overwrite: bool = True) -> bool:
        """Returns True when the key was newly created."""
        if self._server is None:
            with self._dict_lock:
                if self._server is None:  # not migrated mid-wait
                    exists = key in self._dict
                    if overwrite or not exists:
                        self._dict[key] = value
                        self._mutations += 1
                    return not exists
        return self._server.kv_fast_put(
            key.encode(), pickle.dumps(value, protocol=5), overwrite)

    def get(self, key: str) -> Any:
        if self._server is None:
            with self._dict_lock:
                if self._server is None:
                    return self._dict.get(key)
        raw = self._server.kv_fast_get(key.encode())
        return None if raw is None else pickle.loads(raw)

    def delete(self, key: str) -> bool:
        if self._server is None:
            with self._dict_lock:
                if self._server is None:
                    if key in self._dict:
                        del self._dict[key]
                        self._mutations += 1
                        return True
                    return False
        return self._server.kv_fast_del(key.encode())

    def keys(self, prefix: str = "") -> List[str]:
        if self._server is None:
            with self._dict_lock:
                if self._server is None:
                    return [k for k in self._dict if k.startswith(prefix)]
        return [k.decode()
                for k in self._server.kv_fast_keys(prefix.encode())]

    def items(self) -> Dict[str, Any]:
        if self._server is None:
            with self._dict_lock:
                if self._server is None:
                    return dict(self._dict)
        return {k.decode(): pickle.loads(v)
                for k, v in self._server.kv_fast_items().items()}

    def items_raw(self) -> Dict[str, bytes]:
        """Pickled-value form — what snapshots store: skips the
        loads-then-redump round trip over possibly-megabyte blobs."""
        if self._server is None:
            with self._dict_lock:
                if self._server is None:
                    return {k: pickle.dumps(v, protocol=5)
                            for k, v in self._dict.items()}
        return {k.decode(): v
                for k, v in self._server.kv_fast_items().items()}

    def put_raw(self, key: str, raw: bytes) -> None:
        """Restore one snapshot entry (already-pickled value)."""
        if self._server is None:
            with self._dict_lock:
                if self._server is None:
                    self._dict[key] = pickle.loads(raw)
                    self._mutations += 1
                    return
        self._server.kv_fast_put(key.encode(), raw)

    def version(self) -> int:
        """Mutation counter — client fast-path writes bypass Python, so
        persistence polls this instead of relying on handler dirty bits."""
        if self._server is not None:
            return self._server.kv_fast_version()
        return self._mutations


class _NodeEntry:
    __slots__ = ("node_id", "address", "shm_name", "resources", "alive",
                 "last_seen", "missed")

    def __init__(self, node_id: str, address: str, shm_name: str,
                 resources: Dict[str, float]):
        self.node_id = node_id
        self.address = address
        self.shm_name = shm_name
        self.resources = resources
        self.alive = True
        self.last_seen = time.monotonic()
        self.missed = 0


class _ActorEntry:
    __slots__ = ("actor_id", "spec_bytes", "state", "address", "node_id",
                 "worker_id", "restarts_left", "max_task_retries", "reason",
                 "name_key", "resources", "owner_addr", "class_name",
                 "num_restarts", "pg", "lease_resources", "pg_drawn_bundle",
                 "runtime_env")

    def __init__(self, actor_id: bytes, spec_bytes: bytes, restarts_left: int,
                 max_task_retries: int, name_key: str,
                 resources: Dict[str, float], owner_addr: str,
                 class_name: str):
        self.actor_id = actor_id
        self.spec_bytes = spec_bytes
        self.state = PENDING
        self.address: Optional[str] = None
        self.node_id: Optional[str] = None
        self.worker_id: Optional[bytes] = None
        self.restarts_left = restarts_left
        self.max_task_retries = max_task_retries
        self.reason = ""
        self.name_key = name_key
        self.resources = resources
        self.owner_addr = owner_addr
        self.class_name = class_name
        self.num_restarts = 0
        self.pg = None  # (pg_id, bundle_index) when PG-scheduled
        # physical shape for the node lease (chip env etc.); differs from
        # `resources` for PG actors, whose cluster accounting lives in the
        # bundle reservation
        self.lease_resources = dict(resources)
        self.pg_drawn_bundle: Optional[int] = None
        self.runtime_env: Optional[dict] = None


class _LeaseEntry:
    __slots__ = ("lease_id", "node_id", "worker_id", "worker_addr",
                 "resources", "created", "peer", "pg_id", "bundle_index",
                 "fast_key")

    def __init__(self, lease_id: str, node_id: str, worker_id: bytes,
                 worker_addr: str, resources: Dict[str, float], peer,
                 pg_id: Optional[bytes] = None, bundle_index: int = -1,
                 fast_key: Optional[int] = None):
        self.lease_id = lease_id
        self.node_id = node_id
        self.worker_id = worker_id
        self.worker_addr = worker_addr
        self.resources = resources
        self.created = time.monotonic()
        self.peer = peer  # requesting connection; leases die with it
        self.pg_id = pg_id
        self.bundle_index = bundle_index
        # set for grants living in the native lease pool (transport.cc
        # FastLease): peer is None there — the C loop tracks the holder
        self.fast_key = fast_key


class Head:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 session: str = "", persist_path: str = ""):
        self.session = session
        # Distinguishes head processes across restarts: node daemons compare
        # it on every liveness poll and re-register when it changes
        # (reference: GCS restart detection — raylets reconnect and actors
        # re-resolve, gcs_server/gcs_init_data.h + gcs_actor_manager.h:324).
        self.incarnation = os.urandom(4).hex()
        # Table durability (reference: GCS table persistence via Redis,
        # store_client/redis_store_client.h): KV + job counter + actor
        # directory + placement groups snapshot to disk; on restart the
        # tables are rebuilt and reconciled against re-registering nodes.
        # Leases are deliberately NOT persisted — they are bound to client
        # connections, and clients fall back to returning leased workers
        # directly to their node when the head forgot the lease.
        self._persist_path = persist_path
        self._persist_dirty = False
        self._persisted_kv_version = 0  # last KV version snapshotted
        # serializes snapshot WRITES (persist loop vs stop(): two threads
        # sharing one .tmp path would interleave into a torn pickle)
        self._persist_write_lock = threading.Lock()
        # prompt-flush signal: rare-but-important transitions (actor
        # ready/dead, PG created) kick the persist loop instead of waiting
        # out the 1s batch tick, narrowing the window a hard head kill can
        # lose a transition in (KV writes stay batched)
        self._persist_kick = threading.Event()
        # actor_ids/pg_ids restored from a snapshot, awaiting a node
        # re-registration that claims them; swept after the recovery grace
        self._recovering_actors: set = set()
        self._recovering_pgs: set = set()
        # restored actors that had no worker yet: re-placed at boot
        self._respawn_on_boot: list = []
        self.cluster = ClusterState()
        cfg = config_mod.GlobalConfig
        self.cluster.set_spread_threshold(cfg.scheduler_spread_threshold)
        self._lock = threading.RLock()
        self._nodes: Dict[str, _NodeEntry] = {}
        self._actors: Dict[bytes, _ActorEntry] = {}
        self._named: Dict[str, bytes] = {}  # "ns:name" -> actor_id
        self._actor_by_worker: Dict[bytes, bytes] = {}  # worker_id -> actor_id
        self._kv = _KvStore()
        self._pgs: Dict[bytes, dict] = {}  # PlacementGroupID bin -> info
        self._next_job = 0
        if self._persist_path:
            # restore BEFORE the RPC server exists: a client whose ping
            # succeeded must never read a miss on persisted keys or have
            # a fresh put clobbered by the stale snapshot applying late
            self._load_snapshot()
        self._leases: Dict[str, _LeaseEntry] = {}
        self._lease_counter = 0
        # telemetry (reference: GcsTaskManager events + metrics agent):
        # per-worker metric snapshots + bounded task-span ring buffer
        self._metrics: Dict[str, dict] = {}
        self._objects: Dict[str, dict] = {}  # worker -> object summary
        self._task_events: collections.deque = collections.deque(
            maxlen=cfg.event_buffer_size)
        # hardware time series (node samplers push via telemetry_push):
        # fixed rings per (node, metric, tags) — see util/timeseries.py
        from ray_tpu_torch.util.timeseries import TimeSeriesStore
        self._timeseries = TimeSeriesStore(
            maxlen=cfg.timeseries_ring_points)
        # LLM request records (llm/request_log.py flight recorders ship
        # over telemetry_push): rid -> wire dict, bounded ring — the
        # backing store for `python -m ray_tpu_torch requests` / /api/requests
        self._llm_requests: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._llm_requests_cap = max(2, cfg.llm_request_log_size)
        # structured cluster event journal (reference: GCS cluster-event
        # log surfaced by `ray list cluster-events`): node/worker/actor
        # transitions, spill overflows, lease failures, autoscaler moves —
        # sequenced at arrival, dumped via events_dump
        from ray_tpu_torch.runtime.event_journal import ClusterEventJournal
        self.journal = ClusterEventJournal(
            capacity=cfg.cluster_event_journal_size)
        # cluster-wide sampling-profiler plane (util/stack_profiler.py):
        # every process's collapsed-stack exports ride telemetry_push into
        # per-process rings here, merged on read by profiles_dump — and the
        # head profiles ITSELF (the 1.7k-LoC Python policy the slow
        # control-plane rows blame needs frame-level evidence)
        from ray_tpu_torch.util import stack_profiler as profiler_mod
        self._profiler_mod = profiler_mod
        self._profiles = profiler_mod.ProfileStore()
        try:
            profiler_mod.ensure_started()
        except Exception:  # noqa: BLE001 — profiling must never stop boot
            pass
        # structured log plane (util/log_plane.py): every process's log
        # ring rides telemetry_push into per-process rings here, served
        # by logs_dump — and the head logs ITSELF (snapshot warnings,
        # lifecycle diagnostics) into the same store + head.log
        from ray_tpu_torch.util import log_plane as log_plane_mod
        self._log_plane_mod = log_plane_mod
        self._logs = log_plane_mod.LogStore()
        try:
            log_plane_mod.ensure_started(
                role="head",
                log_dir=log_plane_mod.session_log_dir(session),
                filename="head.log")
            log_plane_mod.get_logger().info(
                f"head started (session {session})")
        except Exception:  # noqa: BLE001 — logging must never stop boot
            pass
        # XLA compile observability plane (util/compile_tracker.py):
        # every jax-bearing process's compile-record ring rides
        # telemetry_push into per-process rings here, served by
        # compiles_dump. The head starts its own tracker for symmetry —
        # it never imports jax, so the listeners never hook
        from ray_tpu_torch.util import compile_tracker as compile_mod
        self._compile_mod = compile_mod
        self._compiles = compile_mod.CompileStore()
        try:
            compile_mod.ensure_started(role="head")
        except Exception:  # noqa: BLE001 — tracking must never stop boot
            pass
        # unserviceable demand, deduped per (requester, shape): each
        # submitter polls its shape every ~0.2s, so per-poll appends would
        # over-count 25x per window (the autoscaler's demand signal;
        # reference: GcsAutoscalerStateManager pending-demand reporting)
        self._demand: Dict[tuple, dict] = {}
        self._node_clients = ClientPool(name="head->node")
        self._stopped = threading.Event()
        # general topic pub/sub + the head's own cluster-event feed on it
        # (reference: GCS pubsub node/actor channels, publisher.h:297)
        from ray_tpu_torch.runtime.pubsub import PubsubBroker
        self.pubsub = PubsubBroker(epoch=self.incarnation)
        self.server = RpcServer({
            "register_node": self._h_register_node,
            "unregister_node": self._h_unregister_node,
            "list_nodes": self._h_list_nodes,
            "connect_driver": self._h_connect_driver,
            "kv_put": self._h_kv_put,
            "kv_get": self._h_kv_get,
            "kv_del": self._h_kv_del,
            "kv_keys": self._h_kv_keys,
            "request_lease": self._h_request_lease,
            "retire_demand": self._h_retire_demand,
            "release_lease": self._h_release_lease,
            "create_actor": self._h_create_actor,
            "actor_ready": self._h_actor_ready,
            "actor_failed": self._h_actor_failed,
            "get_actor": self._h_get_actor,
            "get_actor_by_name": self._h_get_actor_by_name,
            "kill_actor": self._h_kill_actor,
            "worker_died": self._h_worker_died,
            "create_placement_group": self._h_create_pg,
            "remove_placement_group": self._h_remove_pg,
            "get_placement_group": self._h_get_pg,
            "cluster_resources": self._h_cluster_resources,
            "available_resources": self._h_available_resources,
            "state_dump": self._h_state_dump,
            "telemetry_push": self._h_telemetry_push,
            "metrics_dump": self._h_metrics_dump,
            "timeline_dump": self._h_timeline_dump,
            "timeseries_dump": self._h_timeseries_dump,
            "requests_dump": self._h_requests_dump,
            "events_dump": self._h_events_dump,
            "objects_dump": self._h_objects_dump,
            "profiles_dump": self._h_profiles_dump,
            "logs_dump": self._h_logs_dump,
            "compiles_dump": self._h_compiles_dump,
            "profiles_record": self._h_profiles_record,
            "journal_record": self._h_journal_record,
            "autoscaler_state": self._h_autoscaler_state,
            "pubsub_publish": lambda p, c: self.pubsub.publish(
                p["topic"], p["message"]),
            "pubsub_poll": lambda p, c: self.pubsub.poll(
                p["cursors"], p.get("timeout_s", 2.0)),
            "pubsub_topics": lambda p, c: self.pubsub.topics(),
            "ping": lambda p, c: {"pong": True,
                                  "incarnation": self.incarnation},
        }, host=host, port=port, max_workers=32, name="head")
        # Native kv/ping service: with the C++ transport, kv_put/kv_get/
        # kv_del/ping fast-frames are answered inside the event loop — the
        # head's Python never runs for them (SURVEY §2.2 native control
        # plane; the Python handlers above remain for pickle-path clients
        # and both views share one table).
        self._kv.attach_native(self.server, int(self.incarnation, 16))
        # a crashed client can't release its leases; reclaim them when its
        # connection drops (reference: raylet returns leased workers when
        # the owner dies — lease lifetime is bound to the owner)
        self.server.on_disconnect = self._on_client_disconnect
        # Native lease pool (verdict: "serve lease grant/release as native
        # fast frames with Python keeping only placement policy"): Python
        # pre-stocks ready grants per resource-shape sig; FOP_LEASE_ACQ/REL
        # are then served inside the C loop. Python keeps placement
        # (stocking), reclamation, and drain policy.
        self._fast_lease_on = (
            config_mod.GlobalConfig.fast_lease_pool_target > 0
            and self._kv.native  # fast frames route into the C loop
            and hasattr(self.server, "lease_stock")
            and hasattr(self.server, "on_disconnect_conn"))
        self._restock_wants: Dict[int, dict] = {}  # sig -> resources/want
        self._stocked_sigs: set = set()  # every sig EVER stocked (drain set)
        self._restock_kick = threading.Event()
        self._fast_hits_seen = 0
        self._fast_idle_since = time.monotonic()
        # Python-path pool consumption (the pool-first branch in
        # _h_request_lease) — folded into the idle-drain activity check:
        # C-loop `hits` alone misses a steady Python-path consumer and
        # drains a pool that is actually hot.
        self._py_unstocks = 0
        if self._fast_lease_on:
            self.server.on_disconnect_conn = self._on_conn_fastlease_reclaim
            threading.Thread(target=self._restock_loop, daemon=True,
                             name="head-fastlease").start()
        self.address = self.server.address
        if self._persist_path:
            self._persist_thread = threading.Thread(
                target=self._persist_loop, daemon=True, name="head-persist")
            self._persist_thread.start()
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True, name="head-health")
        self._health_thread.start()
        if self._recovering_actors or self._recovering_pgs:
            threading.Thread(target=self._recovery_grace_loop, daemon=True,
                             name="head-recovery").start()
        for entry in self._respawn_on_boot:
            self._spawn_actor(entry)
        self._respawn_on_boot = []

    # ----------------------------------------------------- table durability

    #: _ActorEntry fields snapshotted verbatim (placement fields are
    #: deliberately excluded: node_id/worker_id/address are reconciled
    #: against re-registering nodes, never trusted from disk)
    _ACTOR_PERSIST_FIELDS = ("spec_bytes", "state", "restarts_left",
                             "max_task_retries", "reason", "name_key",
                             "resources", "owner_addr", "class_name",
                             "num_restarts", "pg", "lease_resources",
                             "runtime_env")

    def _load_snapshot(self) -> None:
        if not os.path.exists(self._persist_path):
            return  # fresh cluster: nothing to restore
        try:
            with open(self._persist_path, "rb") as f:
                data = pickle.load(f)
        except Exception as e:  # noqa: BLE001 — unreadable/torn snapshot
            from ray_tpu_torch.util import log_plane
            log_plane.get_logger().warning(
                f"discarding unreadable head snapshot "
                f"{self._persist_path}: {e!r}")
            return
        with self._lock:
            for k, raw in data.get("kv_raw", {}).items():
                self._kv.put_raw(k, raw)
            for k, v in data.get("kv", {}).items():  # legacy snapshots
                self._kv.put(k, v)
            self._next_job = max(self._next_job, data.get("next_job", 0))
            for rec in data.get("actors", ()):
                entry = _ActorEntry(rec["actor_id"], rec["spec_bytes"],
                                    rec["restarts_left"],
                                    rec["max_task_retries"], rec["name_key"],
                                    rec["resources"], rec["owner_addr"],
                                    rec["class_name"])
                for f in self._ACTOR_PERSIST_FIELDS:
                    if f in rec:
                        setattr(entry, f, rec[f])
                if entry.state != DEAD:
                    if rec.get("had_worker"):
                        # was live when the snapshot landed: hold in
                        # RESTARTING until its node re-registers and claims
                        # the still-running worker, or the grace expires
                        entry.state = RESTARTING
                        self._recovering_actors.add(entry.actor_id)
                    else:
                        # never had a worker (placement was in flight and
                        # died with the old head): place it fresh instead
                        # of burning a restart in the lost-worker path.
                        # Bump the fencing epoch WITHOUT consuming a
                        # restart: if a stale snapshot hid a worker that
                        # did start, its actor_ready carries the old
                        # num_restarts and is rejected, and re-registration
                        # kills it as unclaimed.
                        entry.state = PENDING
                        entry.num_restarts += 1
                        self._respawn_on_boot.append(entry)
                self._actors[entry.actor_id] = entry
            self._named.update(data.get("named", {}))
            for pg_id, pg in data.get("pgs", {}).items():
                pg = dict(pg)
                # lease draws died with their clients; actor draws are
                # re-established on reconcile
                pg["used"] = [dict() for _ in pg["bundles"]]
                if pg["state"] == "CREATED":
                    # keep the node mapping provisionally; bundles are
                    # re-acquired per node as nodes return (grace sweep
                    # reschedules pgs whose nodes never come back)
                    pg["_acq"] = set()
                    self._recovering_pgs.add(pg_id)
                self._pgs[pg_id] = pg

    def _save_snapshot(self) -> None:
        with self._persist_write_lock:
            with self._lock:
                # KV dirtiness comes from the table's mutation counter
                # (native fast-path writes never run Python handlers).
                # Checked HERE, not only in the poll loop, so stop()'s
                # final snapshot can't miss writes newer than the loop's
                # last 1s tick.
                v = self._kv.version()
                if v != self._persisted_kv_version:
                    self._persisted_kv_version = v
                    self._persist_dirty = True
                if not self._persist_dirty:
                    return
                actors = []
                for aid, e in self._actors.items():
                    rec = {"actor_id": aid,
                           "had_worker": e.worker_id is not None}
                    for f in self._ACTOR_PERSIST_FIELDS:
                        rec[f] = getattr(e, f)
                    actors.append(rec)
                pgs = {}
                for pid, pg in self._pgs.items():
                    pgs[pid] = {k: pg[k] for k in
                                ("bundles", "nodes", "state", "strategy",
                                 "name")}
                snap = {"kv_raw": self._kv.items_raw(),
                        "next_job": self._next_job,
                        "actors": actors, "named": dict(self._named),
                        "pgs": pgs}
                self._persist_dirty = False
            try:
                tmp = self._persist_path + ".tmp"
                os.makedirs(os.path.dirname(self._persist_path) or ".",
                            exist_ok=True)
                with open(tmp, "wb") as f:
                    pickle.dump(snap, f)
                os.replace(tmp, self._persist_path)
            except Exception:
                # failed write must not discard the dirty state: re-mark
                # so the loop retries once the disk recovers
                with self._lock:
                    self._persist_dirty = True
                raise

    def _persist_loop(self) -> None:
        while not self._stopped.is_set():
            self._persist_kick.wait(timeout=1.0)
            self._persist_kick.clear()
            if self._stopped.is_set():
                return  # stop() takes the final snapshot itself
            try:
                self._save_snapshot()
            except Exception:  # noqa: BLE001
                pass

    # ------------------------------------------------------ restart recovery

    def _recovery_grace_loop(self) -> None:
        """After a restart, wait for nodes to re-register and claim the
        restored actors/PGs; whatever is still unclaimed when the grace
        expires is treated as lost (actors take the normal restart path,
        PGs go back to PENDING and reschedule)."""
        grace = config_mod.GlobalConfig.head_recovery_grace_s
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline and not self._stopped.is_set():
            with self._lock:
                if not self._recovering_actors and not self._recovering_pgs:
                    return
            time.sleep(0.1)
        displaced: List[tuple] = []  # (actor_id, node_addr, worker_id)
        with self._lock:
            lost_actors = [aid for aid in self._recovering_actors
                           if aid in self._actors]
            self._recovering_actors.clear()
            lost_pgs = list(self._recovering_pgs)
            self._recovering_pgs.clear()
            for pg_id in lost_pgs:
                pg = self._pgs.get(pg_id)
                if pg is None:
                    continue
                # release what partial re-acquisition happened, then let
                # the scheduler place the whole group fresh
                for idx in pg.pop("_acq", ()):
                    node_id = pg["nodes"][idx]
                    if node_id in self._nodes and self._nodes[node_id].alive:
                        self.cluster.release(node_id, pg["bundles"][idx])
                pg["state"] = "PENDING"
                pg["nodes"] = None
                pg["used"] = [dict() for _ in pg["bundles"]]
                self._persist_dirty = True
                # actors already reconciled into this group are now running
                # outside any reservation: displace them so the restart
                # path re-places them once the group reschedules
                for aid, e in self._actors.items():
                    if e.pg is not None and e.pg[0] == pg_id and \
                            e.state == ALIVE and e.worker_id is not None:
                        node = self._nodes.get(e.node_id)
                        displaced.append(
                            (aid, node.address if node is not None and
                             node.alive else None, e.worker_id))
        for aid, node_addr, worker_id in displaced:
            if node_addr is not None:
                try:
                    self._node_clients.get(node_addr).call(
                        "kill_worker", {"worker_id": worker_id})
                except RpcError:
                    pass
            self._on_actor_worker_lost(
                aid, "placement group rescheduled after head restart")
        for aid in lost_actors:
            self._on_actor_worker_lost(
                aid, "worker lost across head restart")
        if lost_pgs:
            self._try_schedule_pgs()

    # ------------------------------------------------------------- membership

    def _h_register_node(self, p, ctx):
        """Admit (or re-admit) a node. A re-registration after a head
        restart carries the node's still-running actor workers; the head
        claims them for the restored actor entries and tells the node to
        kill workers whose actors it no longer knows (reference: raylet
        reconnect after GCS restart — gcs_init_data.h rebuild + actor
        re-resolution, gcs_actor_manager.h:324)."""
        node_id = p["node_id"]
        kill: List[bytes] = []
        with self._lock:
            known = self._nodes.get(node_id)
            new_node = known is None or not known.alive
            if new_node:
                entry = _NodeEntry(node_id, p["address"], p["shm_name"],
                                   p["resources"])
                self._nodes[node_id] = entry
                self.cluster.add_node(node_id, p["resources"])
            else:
                # idempotent re-register (e.g. a transient network blip on
                # the node side, same head incarnation): refresh liveness
                known.address = p["address"]
                known.last_seen = time.monotonic()
                known.missed = 0
            # re-acquire bundle reservations for recovering PGs mapped here
            for pg_id in list(self._recovering_pgs):
                pg = self._pgs.get(pg_id)
                if pg is None or pg.get("nodes") is None:
                    self._recovering_pgs.discard(pg_id)
                    continue
                for idx, nid in enumerate(pg["nodes"]):
                    if nid == node_id and idx not in pg["_acq"]:
                        if self.cluster.acquire(node_id, pg["bundles"][idx]):
                            pg["_acq"].add(idx)
                if len(pg["_acq"]) == len(pg["bundles"]):
                    pg.pop("_acq", None)
                    self._recovering_pgs.discard(pg_id)
            # claim reported actor workers for restored actor entries
            for aw in p.get("actor_workers", ()):
                aid = aw.get("actor_id")
                entry2 = self._actors.get(aid) if aid is not None else None
                if entry2 is not None and \
                        entry2.worker_id == aw["worker_id"] and \
                        entry2.state != DEAD:
                    # idempotent re-claim: a repeated re-registration (first
                    # reply lost on the node side) must not disown workers
                    # the previous attempt already reconciled
                    entry2.address = aw["address"]
                    entry2.node_id = node_id
                    continue
                if entry2 is None or entry2.state == DEAD or \
                        aid not in self._recovering_actors:
                    kill.append(aw["worker_id"])
                    continue
                entry2.state = ALIVE
                entry2.node_id = node_id
                entry2.worker_id = aw["worker_id"]
                entry2.address = aw["address"]
                self._actor_by_worker[aw["worker_id"]] = aid
                if entry2.pg is None:
                    self.cluster.acquire(node_id, entry2.resources)
                self._recovering_actors.discard(aid)
                self._persist_dirty = True
        if new_node:
            self.pubsub.publish("cluster_events", {
                "event": "node_added", "node_id": node_id,
                "address": p["address"], "ts": time.time()})
            self.journal.record("node_register", node_id=node_id,
                                address=p["address"],
                                resources=dict(p["resources"]))
        return {"session": self.session, "incarnation": self.incarnation,
                "kill": kill}

    def _h_unregister_node(self, p, ctx):
        self._mark_node_dead(p["node_id"], "unregistered")
        return True

    def _h_list_nodes(self, p, ctx):
        with self._lock:
            return [{"node_id": n.node_id, "address": n.address,
                     "shm_name": n.shm_name, "resources": n.resources,
                     "alive": n.alive}
                    for n in self._nodes.values()]

    def _h_connect_driver(self, p, ctx):
        with self._lock:
            self._next_job += 1
            job = self._next_job
            self._persist_dirty = True
        return {"job_id": job, "session": self.session,
                "nodes": self._h_list_nodes(None, None)}

    # --------------------------------------------------------------------- kv

    def _h_kv_put(self, p, ctx):
        # pickle-path clients; clients on the fast path (kv_put through
        # call_fast) never reach here. Both write
        # the same table (_KvStore); persistence dirtiness is tracked by
        # the kv version counter in _persist_loop, so no-op puts (the
        # overwrite=False dedup path every worker hits re-exporting the
        # same function blobs) don't force snapshot rewrites.
        return self._kv.put(p["key"], p["value"], p.get("overwrite", True))

    def _h_kv_get(self, p, ctx):
        return self._kv.get(p["key"])

    def _h_kv_del(self, p, ctx):
        # dirtiness via the version counter, as in _h_kv_put
        return self._kv.delete(p["key"])

    def _h_kv_keys(self, p, ctx):
        return self._kv.keys(p.get("prefix", ""))

    # ----------------------------------------------------------------- leases

    def _schedule_and_acquire(self, resources: Dict[str, float],
                              policy: str = "hybrid",
                              affinity_node: str = "",
                              soft: bool = False,
                              _drain_on_busy: bool = True) -> Optional[str]:
        for attempt in (0, 1):
            with self._lock:
                node_id = self.cluster.schedule(
                    resources, _POLICY_BY_NAME.get(policy, POLICY_HYBRID),
                    affinity_node=affinity_node, soft=soft)
                if node_id is not None:
                    if not self.cluster.acquire(node_id, resources):
                        node_id = None
                if node_id is not None:
                    return node_id
            # busy: pooled fast-lease grants may be holding the capacity —
            # drain them (opportunistic pool, never allowed to starve real
            # demand past one round-trip) and retry once
            if attempt == 0 and _drain_on_busy and self._fast_lease_on:
                if self._drain_all_pools() == 0:
                    return None
            else:
                return None
        return None

    def _release(self, node_id: str, resources: Dict[str, float]) -> None:
        with self._lock:
            if node_id in self._nodes and self._nodes[node_id].alive:
                self.cluster.release(node_id, resources)

    def _record_sched_event(self, name: str, start: float) -> None:
        """Head-side scheduler-phase span, appended straight to the
        timeline deque (the head process has no telemetry flush loop —
        it IS the collector). Lets `python -m ray_tpu_torch trace` / timeline
        consumers see where lease grants came from and what they cost."""
        self._task_events.append({
            "name": name, "task_id": "", "kind": "sched",
            "start": start, "end": time.time(), "ok": True,
            "worker": "head", "node": "head"})

    def _h_retire_demand(self, p, ctx):
        """The requester has nothing left pending for this shape (its
        tasks went to leases it already held): retire the demand its
        failed requests recorded, which no grant will now pop. Left in
        place it stays in the autoscaler's window and launches a node for
        work that is done."""
        key = (str(ctx.peer), tuple(sorted(p["resources"].items())))
        with self._lock:
            self._demand.pop(key, None)
        return True

    def _h_request_lease(self, p, ctx):
        """Grant (node, worker) for a resource shape; None if infeasible now.

        Reply: {lease_id, node_id, worker_id, worker_addr, shm_name} or
        {retry: True} when resources are busy, or {infeasible: True} when no
        node could ever satisfy the shape.

        With pg_id set, the lease comes from the bundle's reserved node and
        no extra resources are acquired — the PG already holds them
        (reference: PlacementGroupSchedulingStrategy +
        placement_group_resource_manager.h bundle accounting).
        """
        t_req = time.time()
        resources = p["resources"]
        pg_id = p.get("pg_id")
        if self._fastlease_eligible(p, pg_id):
            # Arm the native pool for this shape: the NEXT acquire for it
            # is served inside the C loop (this one proceeds via Python).
            # Depth is DEMAND-BOUNDED by the submitter's pending hint: an
            # isolated task (pending=1) stocks nothing, a burst stocks up
            # to the target — unconditional deep stocking caused a
            # worker-spawn storm that starved small hosts.
            want = min(config_mod.GlobalConfig.fast_lease_pool_target,
                       max(0, int(p.get("pending", 1)) - 1))
            sig = wire.lease_sig(resources)
            if want > 0:
                with self._lock:
                    cur = self._restock_wants.get(sig)
                    self._restock_wants[sig] = {
                        "resources": dict(resources),
                        "want": max(want, cur["want"] if cur else 0)}
                self._restock_kick.set()
            # Pool-first: a Python-path request for a pooled shape serves
            # straight from the pool. Without this, concurrent requester
            # threads race their own pool — the Python path sees the
            # capacity as busy, drain-on-busy rips grants out from under
            # sibling fast acquires, and restock churns (measured 28%
            # single-client regression).
            item = self.server.lease_unstock(sig)
            if item is not None:
                _lkey, blob = item
                try:
                    g = pickle.loads(blob)
                except Exception:  # noqa: BLE001
                    g = None
                live = False
                if g is not None:
                    with self._lock:
                        e = self._leases.get(g["lease_id"])
                        if e is not None:
                            # now an ordinary Python lease: bound to this
                            # peer for disconnect reclaim, out of the
                            # C-side tables
                            e.peer = ctx.peer if ctx is not None else None
                            e.fast_key = None
                            live = True
                if live:
                    self._py_unstocks += 1
                    self._record_sched_event("lease::pool", t_req)
                    return {k: g[k] for k in
                            ("lease_id", "node_id", "worker_id",
                             "worker_addr", "node_addr", "shm_name")}
                # Stale pooled grant: its _LeaseEntry was already released
                # (resources returned by _h_release_lease) — handing it
                # out would point the client at a worker the node may
                # have reclaimed, and release of the reissued lease_id
                # would be a no-op double-spend. Discard and fall through
                # to ordinary scheduling.
        if pg_id is not None:
            return self._pg_lease(p, pg_id, ctx)
        node_id = self._schedule_and_acquire(
            resources, policy=p.get("policy", "hybrid"),
            affinity_node=p.get("affinity_node", ""),
            soft=p.get("soft", False))
        if node_id is not None:
            with self._lock:  # shape satisfied: retire its demand entry
                self._demand.pop(
                    (str(ctx.peer), tuple(sorted(resources.items()))),
                    None)
        if node_id is None:
            # distinguish busy from impossible: try against total capacity
            with self._lock:
                feasible = any(
                    all(n.resources.get(k, 0.0) >= v
                        for k, v in resources.items())
                    for n in self._nodes.values() if n.alive)
                key = (str(ctx.peer), tuple(sorted(resources.items())))
                self._demand[key] = {
                    "ts": time.time(), "resources": dict(resources),
                    "count": max(1, int(p.get("pending", 1)))}
            return {"infeasible": not feasible, "retry": feasible}
        node = self._nodes[node_id]
        try:
            grant = self._node_clients.get(node.address).call(
                "lease_worker", {"resources": resources,
                                 "runtime_env": p.get("runtime_env")})
        except RpcError as e:
            self._release(node_id, resources)
            self._mark_node_dead(node_id, f"lease rpc failed: {e}")
            return {"retry": True}
        except Exception as e:  # node-side bug: don't leak the acquisition
            self._release(node_id, resources)
            return {"infeasible": True, "reason": f"lease failed: {e}"}
        if grant is None:
            self._release(node_id, resources)
            return {"retry": True}
        if isinstance(grant, dict) and "invalid" in grant:
            self._release(node_id, resources)
            return {"infeasible": True, "reason": grant["invalid"]}
        with self._lock:
            self._lease_counter += 1
            lease_id = f"l{self.incarnation}.{self._lease_counter}"
            self._leases[lease_id] = _LeaseEntry(
                lease_id, node_id, grant["worker_id"], grant["worker_addr"],
                resources, ctx.peer if ctx is not None else None)
        self._record_sched_event("lease::grant", t_req)
        return {"lease_id": lease_id, "node_id": node_id,
                "worker_id": grant["worker_id"],
                "worker_addr": grant["worker_addr"],
                "node_addr": node.address,
                "shm_name": node.shm_name}

    def _pg_lease(self, p, pg_id: bytes, ctx=None):
        resources = p["resources"]
        with self._lock:
            pg = self._pgs.get(pg_id)
            if pg is None:
                return {"infeasible": True, "retry": False,
                        "reason": "placement group removed"}
            if pg["state"] != "CREATED":
                return {"retry": True}
            idx = p.get("bundle_index", -1)
            if idx >= len(pg["bundles"]):
                return {"infeasible": True,
                        "reason": f"bundle index {idx} out of range "
                                  f"({len(pg['bundles'])} bundles)"}
            # per-bundle usage accounting: a lease draws down its bundle's
            # reservation so concurrent tasks can't overrun into another
            # PG's chips (reference: placement_group_resource_manager.h)
            if idx < 0:
                idx = next((i for i in range(len(pg["bundles"]))
                            if _bundle_fits(pg, i, resources)), -1)
                if idx < 0:
                    return {"retry": True}
            elif not _bundle_fits(pg, idx, resources):
                return {"retry": True}
            _bundle_draw(pg, idx, resources)
            node_id = pg["nodes"][idx]
            node = self._nodes.get(node_id)
        if node is None or not node.alive:
            self._bundle_return(pg_id, idx, resources)
            return {"retry": True}
        try:
            grant = self._node_clients.get(node.address).call(
                "lease_worker", {"resources": resources,
                                 "runtime_env": p.get("runtime_env")})
        except RpcError as e:
            self._bundle_return(pg_id, idx, resources)
            self._mark_node_dead(node_id, f"lease rpc failed: {e}")
            return {"retry": True}
        except Exception as e:
            self._bundle_return(pg_id, idx, resources)
            return {"infeasible": True, "reason": f"lease failed: {e}"}
        if grant is None:
            self._bundle_return(pg_id, idx, resources)
            return {"retry": True}
        if isinstance(grant, dict) and "invalid" in grant:
            self._bundle_return(pg_id, idx, resources)
            return {"infeasible": True, "reason": grant["invalid"]}
        with self._lock:
            self._lease_counter += 1
            lease_id = f"l{self.incarnation}.{self._lease_counter}"
            # resources recorded for bundle return, not cluster release
            self._leases[lease_id] = _LeaseEntry(
                lease_id, node_id, grant["worker_id"], grant["worker_addr"],
                resources, ctx.peer if ctx is not None else None,
                pg_id=pg_id, bundle_index=idx)
        return {"lease_id": lease_id, "node_id": node_id,
                "worker_id": grant["worker_id"],
                "worker_addr": grant["worker_addr"],
                "node_addr": node.address,
                "shm_name": node.shm_name}

    def _bundle_return(self, pg_id: bytes, idx: int,
                       resources: Dict[str, float]) -> None:
        with self._lock:
            pg = self._pgs.get(pg_id)
            if pg is not None and pg.get("used"):
                used = pg["used"][idx]
                for k, v in resources.items():
                    used[k] = max(0.0, used.get(k, 0.0) - v)

    def _on_client_disconnect(self, peer) -> None:
        with self._lock:
            stale = [l.lease_id for l in self._leases.values()
                     if l.peer == peer]
        if not stale:
            return

        # off-thread: this callback runs on the transport dispatcher and
        # _h_release_lease makes a blocking return_worker call per lease
        def _reclaim():
            for lease_id in stale:
                self._h_release_lease({"lease_id": lease_id}, None)

        threading.Thread(target=_reclaim, daemon=True,
                         name="lease-reclaim").start()

    def _h_release_lease(self, p, ctx):
        with self._lock:
            lease = self._leases.pop(p["lease_id"], None)
        if lease is None:
            return False
        if lease.fast_key is not None and self._fast_lease_on:
            # a Python-path release of a pooled/held fast grant (corpse
            # detected by the client, head restart fallback): make sure the
            # C loop can't re-grant it
            self.server.lease_invalidate(lease.fast_key)
        if lease.pg_id is not None:
            self._bundle_return(lease.pg_id, lease.bundle_index,
                                lease.resources)
        else:
            self._release(lease.node_id, lease.resources)
        node = self._nodes.get(lease.node_id)
        if node is not None and node.alive:
            try:
                self._node_clients.get(node.address).call(
                    "return_worker", {"worker_id": lease.worker_id})
            except RpcError:
                pass
        return True

    # ------------------------------------------------- native lease pool

    def _fastlease_eligible(self, p, pg_id) -> bool:
        return (self._fast_lease_on and pg_id is None
                and not p.get("runtime_env") and not p.get("affinity_node")
                and p.get("policy", "hybrid") == "hybrid"
                and not p.get("soft"))

    def _restock_loop(self) -> None:
        """Placement policy half of the native lease pool: keep each hot
        shape's pool stocked to target depth so FOP_LEASE_ACQ hits in C.
        Stocking is strictly opportunistic — any request that finds the
        cluster busy drains every pool first (_drain_all_pools), so pooled
        grants can only ever cost one retry round-trip of latency."""
        while not self._stopped.is_set():
            self._restock_kick.wait(timeout=1.0)
            self._restock_kick.clear()
            with self._lock:
                wants = dict(self._restock_wants)
            for sig, entry in wants.items():
                while (not self._stopped.is_set()
                       and self.server.lease_depth(sig) < entry["want"]):
                    with self._lock:
                        # a drain may have disarmed this sig since the
                        # snapshot — stocking past it would orphan grants
                        if sig not in self._restock_wants:
                            break
                    if not self._stock_one(sig, entry["resources"]):
                        break

    def _stock_one(self, sig: int, resources: Dict[str, float]) -> bool:
        node_id = self._schedule_and_acquire(resources, _drain_on_busy=False)
        if node_id is None:
            return False
        with self._lock:
            node = self._nodes.get(node_id)
        if node is None:
            self._release(node_id, resources)
            return False
        try:
            grant = self._node_clients.get(node.address).call(
                "lease_worker", {"resources": resources,
                                 "runtime_env": None})
        except RpcError:
            self._release(node_id, resources)
            self.journal.record("lease_grant_failed", node_id=node_id,
                                resources=dict(resources),
                                reason="lease rpc failed (pool stock)")
            self._mark_node_dead(node_id, "lease rpc failed (pool stock)")
            return False
        except Exception as e:  # noqa: BLE001
            self._release(node_id, resources)
            self.journal.record("lease_grant_failed", node_id=node_id,
                                resources=dict(resources), reason=repr(e))
            return False
        if not isinstance(grant, dict) or "worker_id" not in grant:
            self._release(node_id, resources)
            return False
        with self._lock:
            self._lease_counter += 1
            n = self._lease_counter
            lease_id = f"l{self.incarnation}.{n}"
            self._leases[lease_id] = _LeaseEntry(
                lease_id, node_id, grant["worker_id"], grant["worker_addr"],
                dict(resources), None, fast_key=n)
        blob = pickle.dumps({
            "lease_id": lease_id, "node_id": node_id,
            "worker_id": grant["worker_id"],
            "worker_addr": grant["worker_addr"],
            "node_addr": node.address, "shm_name": node.shm_name,
            "fast_key": n}, protocol=5)
        if not self.server.lease_stock(sig, n, blob):
            self._h_release_lease({"lease_id": lease_id}, None)
            return False
        with self._lock:
            self._stocked_sigs.add(sig)
        return True

    def _drain_all_pools(self) -> int:
        """Return every POOLED (un-held) fast grant to the cluster and stop
        restocking until fresh eligible demand re-arms it."""
        with self._lock:
            # drain every sig that EVER stocked, not just currently-armed
            # ones: a restock racing a previous drain can deposit grants
            # after the wants were cleared, and wants-only draining would
            # orphan them (they held a node's capacity forever)
            sigs = set(self._restock_wants) | set(self._stocked_sigs)
            self._restock_wants.clear()  # re-armed by fresh eligible demand
        n = 0
        for sig in sigs:
            while True:
                item = self.server.lease_unstock(sig)
                if item is None:
                    break
                _lkey, blob = item
                try:
                    g = pickle.loads(blob)
                except Exception:  # noqa: BLE001
                    continue
                self._h_release_lease({"lease_id": g["lease_id"]}, None)
                n += 1
        return n

    def _on_conn_fastlease_reclaim(self, conn_id: int, peer) -> None:
        """A connection died holding native-granted leases: release them
        (role of the peer-based reclaim in _on_client_disconnect, driven by
        the C-side holder table instead of Python lease entries)."""
        items = self.server.lease_reclaim_conn(conn_id)
        if not items:
            return

        def _reclaim():
            for _lkey, _sig, blob in items:
                try:
                    g = pickle.loads(blob)
                except Exception:  # noqa: BLE001
                    continue
                self._h_release_lease({"lease_id": g["lease_id"]}, None)

        threading.Thread(target=_reclaim, daemon=True,
                         name="fastlease-reclaim").start()

    # ----------------------------------------------------------------- actors

    def _h_create_actor(self, p, ctx):
        """Register + schedule an actor. Reply immediately; creation is async.

        (Reference: GcsActorManager::RegisterActor/CreateActor,
        gcs_actor_manager.cc:389,475 — the client gets an immediate ack and
        discovers liveness through get_actor polling.)
        """
        actor_id: bytes = p["actor_id"]
        entry = _ActorEntry(
            actor_id, p["spec_bytes"], p["max_restarts"],
            p["max_task_retries"], p.get("name_key", ""),
            p["resources"], p.get("owner_addr", ""), p.get("class_name", ""))
        entry.runtime_env = p.get("runtime_env")
        if p.get("pg_id") is not None:
            # bundle reservations cover the cluster accounting; the node
            # lease still carries the physical shape (lease_resources) so
            # TPU actors get chip allocation + TPU_VISIBLE_CHIPS
            entry.pg = (p["pg_id"], p.get("bundle_index", -1))
            entry.resources = {}
        with self._lock:
            if entry.name_key:
                if entry.name_key in self._named:
                    raise ValueError(
                        f"named actor {entry.name_key!r} already exists")
                self._named[entry.name_key] = actor_id
            self._actors[actor_id] = entry
            self._persist_dirty = True
        self._persist_kick.set()
        self._spawn_actor(entry)
        return True

    def _spawn_actor(self, entry: _ActorEntry) -> None:
        """Try to place the actor; retries in a background thread if busy."""

        def _try_place():
            deadline = time.monotonic() + config_mod.GlobalConfig.rpc_call_timeout_s
            while not self._stopped.is_set():
                with self._lock:
                    if entry.state == DEAD:
                        return  # killed while pending placement
                if entry.pg is not None:
                    node_id = self._pg_actor_node(entry)
                    if node_id is None:
                        time.sleep(0.02)
                        continue
                else:
                    node_id = self._schedule_and_acquire(entry.resources)
                if node_id is not None:
                    node = self._nodes[node_id]
                    try:
                        # the physical shape (lease_resources): a PG
                        # actor's `resources` are empty, its accounting
                        # being the bundle's, but a GPU actor must still
                        # get a card of its own (the JAX package's head
                        # sends `resources` here, so its PG actors get no
                        # chips)
                        grant = self._node_clients.get(node.address).call(
                            "lease_worker",
                            {"resources": entry.lease_resources,
                             "runtime_env": entry.runtime_env})
                    except RpcError:
                        self._release(node_id, entry.resources)
                        self._mark_node_dead(node_id, "actor lease rpc failed")
                        continue
                    if grant is None:
                        self._release(node_id, entry.resources)
                        time.sleep(0.05)
                        continue
                    if isinstance(grant, dict) and "invalid" in grant:
                        # unsatisfiable lease (bad TPU shape, runtime_env
                        # materialization failure): surface as creation
                        # failure, don't spin forever
                        self._release(node_id, entry.resources)
                        with self._lock:
                            if entry.state != DEAD:
                                entry.state = DEAD
                                entry.reason = grant["invalid"]
                                self._persist_dirty = True
                        self._persist_kick.set()
                        return
                    with self._lock:
                        if entry.state == DEAD:  # killed during the lease
                            self._release(node_id, entry.resources)
                            grant_dead = True
                        else:
                            grant_dead = False
                            entry.node_id = node_id
                            entry.worker_id = grant["worker_id"]
                            self._actor_by_worker[grant["worker_id"]] = \
                                entry.actor_id
                    if grant_dead:
                        try:
                            self._node_clients.get(node.address).call(
                                "return_worker",
                                {"worker_id": grant["worker_id"]})
                        except RpcError:
                            pass
                        return
                    try:
                        self._node_clients.get(node.address).call(
                            "start_actor", {
                                "worker_id": grant["worker_id"],
                                "actor_id": entry.actor_id,
                                "spec_bytes": entry.spec_bytes,
                                "head_addr": self.address,
                                "num_restarts": entry.num_restarts,
                            })
                    except RpcError as e:
                        self._on_actor_worker_lost(entry.actor_id,
                                                   f"start_actor failed: {e}")
                    return
                # infeasible forever?
                with self._lock:
                    feasible = any(
                        all(n.resources.get(k, 0.0) >= v
                            for k, v in entry.resources.items())
                        for n in self._nodes.values() if n.alive)
                if not feasible and time.monotonic() > deadline:
                    with self._lock:
                        entry.state = DEAD
                        entry.reason = (
                            f"infeasible resources {entry.resources}")
                    return
                time.sleep(0.02)

        threading.Thread(target=_try_place, daemon=True,
                         name="head-actor-place").start()

    def _pg_actor_node(self, entry: _ActorEntry) -> Optional[str]:
        """Bundle's node for a PG-scheduled actor; None while the PG is
        pending. Marks the actor DEAD if its PG was removed."""
        pg_id, idx = entry.pg
        with self._lock:
            pg = self._pgs.get(pg_id)
            if pg is None:
                entry.state = DEAD
                entry.reason = "placement group removed"
                return None
            if pg["state"] != "CREATED":
                return None
            node_id = pg["nodes"][idx if idx >= 0 else 0]
            node = self._nodes.get(node_id)
            if node is None or not node.alive:
                return None
            return node_id

    def _h_actor_ready(self, p, ctx):
        with self._lock:
            entry = self._actors.get(p["actor_id"])
            if entry is None:
                return False
            # Restart fencing: a stale incarnation (e.g. a slow __init__
            # finishing after the head already declared the worker lost and
            # restarted elsewhere) must not flip state back to ALIVE.
            if p.get("num_restarts", 0) != entry.num_restarts or \
                    entry.state == DEAD:
                return False
            entry.state = ALIVE
            entry.address = p["address"]
            self._persist_dirty = True
        self._persist_kick.set()
        return True

    def _h_actor_failed(self, p, ctx):
        """Actor constructor raised — not a crash; no restart (reference
        semantics: creation errors surface to the caller)."""
        with self._lock:
            entry = self._actors.get(p["actor_id"])
            if entry is None:
                return False
            if p.get("num_restarts", 0) != entry.num_restarts or \
                    entry.state == DEAD:
                return False
            entry.state = DEAD
            entry.reason = p.get("reason", "creation failed")
            self._persist_dirty = True
            self._persist_kick.set()
            node = self._nodes.get(entry.node_id) if entry.node_id else None
            worker_id = entry.worker_id
            self._cleanup_actor_placement(entry)
        # the worker process held partial constructor state — reclaim the
        # pool slot by killing it (its death event no-ops: actor is DEAD)
        if node is not None and worker_id is not None and node.alive:
            try:
                self._node_clients.get(node.address).call(
                    "kill_worker", {"worker_id": worker_id})
            except RpcError:
                pass
        return True

    def _cleanup_actor_placement(self, entry: _ActorEntry) -> None:
        """Release resources + pool bookkeeping after an actor leaves a node.

        Caller must hold self._lock.
        """
        if entry.worker_id is not None:
            self._actor_by_worker.pop(entry.worker_id, None)
        if entry.node_id is not None and entry.node_id in self._nodes:
            if self._nodes[entry.node_id].alive:
                self.cluster.release(entry.node_id, entry.resources)
        entry.node_id = None
        entry.worker_id = None
        entry.address = None

    def _h_get_actor(self, p, ctx):
        with self._lock:
            entry = self._actors.get(p["actor_id"])
            if entry is None:
                return None
            return {"state": entry.state, "address": entry.address,
                    "reason": entry.reason,
                    "max_task_retries": entry.max_task_retries,
                    "num_restarts": entry.num_restarts}

    def _h_get_actor_by_name(self, p, ctx):
        key = f"{p['namespace']}:{p['name']}"
        with self._lock:
            actor_id = self._named.get(key)
            if actor_id is None:
                return None
            entry = self._actors[actor_id]
            return {"actor_id": actor_id, "class_name": entry.class_name,
                    "state": entry.state,
                    "max_task_retries": entry.max_task_retries}

    def _h_kill_actor(self, p, ctx):
        actor_id = p["actor_id"]
        with self._lock:
            entry = self._actors.get(actor_id)
            if entry is None:
                return False
            if p.get("no_restart", True):
                entry.restarts_left = 0
                self._persist_dirty = True
            node = self._nodes.get(entry.node_id) if entry.node_id else None
            worker_id = entry.worker_id
            if worker_id is None and entry.state in (PENDING, RESTARTING) \
                    and p.get("no_restart", True):
                # not placed yet: mark dead now so the in-flight placement
                # loop aborts instead of starting a killed actor
                entry.state = DEAD
                entry.reason = "killed before start"
                self._recovering_actors.discard(actor_id)
        if node is not None and worker_id is not None:
            try:
                self._node_clients.get(node.address).call(
                    "kill_worker", {"worker_id": worker_id})
            except RpcError:
                pass
        return True

    # --------------------------------------------------- death + restart path

    def _h_worker_died(self, p, ctx):
        """Node daemon reports a worker process exit (reference: raylet
        worker death -> GcsActorManager::OnWorkerDead).

        Journals the death with its exit cause under a trace id (ambient,
        or freshly minted) that any follow-on actor-restart event shares,
        so `events` shows the causal chain and `trace` can cross-link it.
        """
        from ray_tpu_torch.util.trace_context import current, new_trace_id
        ctx_t = current()
        trace_id = ctx_t[0] if ctx_t else new_trace_id()
        reason = p.get("reason", "worker died")
        wid = p.get("worker_id") or b""
        # crash forensics: the node daemon tails the dead worker's stderr
        # file + structured log file and sends the dying words along —
        # bounded here again so a hostile report can't bloat the journal
        tails = {}
        for k in ("stderr_tail", "log_tail"):
            v = p.get(k)
            if v:
                tails[k] = [str(ln)[:500] for ln in list(v)[-50:]]
        self.journal.record(
            "worker_death", trace_id=trace_id,
            worker_id=wid.hex() if isinstance(wid, bytes) else str(wid),
            node_id=p.get("node_id", ""), exit_cause=reason, **tails)
        self._on_actor_worker_lost(
            None, reason, worker_id=p["worker_id"], trace_id=trace_id)
        return True

    def _on_actor_worker_lost(self, actor_id: Optional[bytes], reason: str,
                              worker_id: Optional[bytes] = None,
                              trace_id: str = "") -> None:
        with self._lock:
            if actor_id is None and worker_id is not None:
                actor_id = self._actor_by_worker.get(worker_id)
            if actor_id is None:
                return  # plain task worker; owners detect via connection loss
            entry = self._actors.get(actor_id)
            if entry is None or entry.state == DEAD:
                return
            self._cleanup_actor_placement(entry)
            if entry.restarts_left != 0:
                if entry.restarts_left > 0:
                    entry.restarts_left -= 1
                entry.state = RESTARTING
                entry.num_restarts += 1
                restart = True
            else:
                entry.state = DEAD
                entry.reason = reason
                restart = False
            self._persist_dirty = True
        self._persist_kick.set()
        self.pubsub.publish("cluster_events", {
            "event": "actor_restarting" if restart else "actor_dead",
            "actor_id": actor_id.hex(), "reason": reason,
            "ts": time.time()})
        self.journal.record(
            "actor_restarting" if restart else "actor_dead",
            trace_id=trace_id, actor_id=actor_id.hex(), reason=reason,
            restarts_left=entry.restarts_left)
        if restart:
            self._spawn_actor(entry)

    def _mark_node_dead(self, node_id: str, reason: str) -> None:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or not node.alive:
                return
            node.alive = False
            self.cluster.remove_node(node_id)
            dead_actor_ids = [aid for aid, e in self._actors.items()
                              if e.node_id == node_id and
                              e.state in (ALIVE, PENDING, RESTARTING)]
        self._node_clients.invalidate(node.address)
        if self._fast_lease_on:
            # fast grants on the dead node are garbage: pull them out of
            # the C pool/held tables so they can't be (re-)granted. The
            # node's resource accounting is already gone (remove_node), so
            # just drop the entries.
            with self._lock:
                dead_fast = [l for l in self._leases.values()
                             if l.node_id == node_id
                             and l.fast_key is not None]
            for l in dead_fast:
                self.server.lease_invalidate(l.fast_key)
                with self._lock:
                    self._leases.pop(l.lease_id, None)
        self.pubsub.publish("cluster_events", {
            "event": "node_dead", "node_id": node_id, "reason": reason,
            "ts": time.time()})
        self.journal.record("node_dead", node_id=node_id, reason=reason)
        for aid in dead_actor_ids:
            self._on_actor_worker_lost(aid, f"node {node_id} died: {reason}")

    def _health_loop(self) -> None:
        cfg = config_mod.GlobalConfig
        period = cfg.health_check_period_ms / 1000.0
        max_missed = max(1, int(cfg.health_check_timeout_ms /
                                cfg.health_check_period_ms))
        while not self._stopped.wait(period):
            with self._lock:
                nodes = [n for n in self._nodes.values() if n.alive]
            for n in nodes:
                try:
                    self._node_clients.get(n.address).call(
                        "ping", timeout=period * 2)
                    n.missed = 0
                    n.last_seen = time.monotonic()
                except RpcError:
                    n.missed += 1
                    if n.missed >= max_missed:
                        self._mark_node_dead(n.node_id, "health check failed")
            # periodic retry of pending placement groups: resources freed
            # by finished leases/actors may now fit a queued reservation
            self._try_schedule_pgs()
            # idle decay of the native lease pool: no acquires for a full
            # drain window -> hand the pooled capacity back
            if self._fast_lease_on:
                stats = self.server.lease_stats()
                if stats is not None:
                    # activity = C-loop pool hits PLUS Python-path pool
                    # consumption (pool-first in _h_request_lease): either
                    # one proves the pool is earning its keep. Counting
                    # only `hits` drained pools under Python-path load —
                    # a false idle.
                    activity = stats["hits"] + self._py_unstocks
                    if activity != self._fast_hits_seen:
                        self._fast_hits_seen = activity
                        self._fast_idle_since = time.monotonic()
                    elif (stats["pooled"] > 0
                          and time.monotonic()
                          - getattr(self, "_fast_idle_since", 0.0)
                          > config_mod.GlobalConfig.fast_lease_idle_drain_s):
                        self._drain_all_pools()

    # ------------------------------------------------------- placement groups

    def _h_create_pg(self, p, ctx):
        """Register a PG; reservation is atomic and retried until feasible
        (reference: GcsPlacementGroupManager pending queue,
        gcs_placement_group_manager.h:228). Clients poll get_placement_group
        for CREATED."""
        with self._lock:
            self._pgs[p["pg_id"]] = {
                "bundles": p["bundles"], "nodes": None, "state": "PENDING",
                "strategy": p["strategy"], "name": p.get("name", "")}
            self._persist_dirty = True
        self._try_schedule_pgs()
        return True

    def _try_schedule_pgs(self) -> None:
        """Attempt atomic reservation of every pending PG (called on create
        and periodically from the health loop so freed resources are
        picked up)."""
        for attempt in (0, 1):
            pending = False
            with self._lock:
                for pg in self._pgs.values():
                    if pg["state"] != "PENDING":
                        continue
                    nodes = self.cluster.schedule_bundles(pg["bundles"],
                                                          pg["strategy"])
                    if nodes is not None:
                        pg["nodes"] = nodes
                        pg["state"] = "CREATED"
                        self._persist_dirty = True
                        self._persist_kick.set()
                    else:
                        pending = True
            # a reservation that can't fit may be blocked by pooled
            # fast-lease grants: drain them and retry once (the pool is
            # opportunistic — real demand always wins)
            if not (attempt == 0 and pending and self._fast_lease_on
                    and self._drain_all_pools() > 0):
                return

    def _h_remove_pg(self, p, ctx):
        with self._lock:
            pg = self._pgs.pop(p["pg_id"], None)
            if pg is None:
                return False
            self._persist_dirty = True
            recovering = p["pg_id"] in self._recovering_pgs
            self._recovering_pgs.discard(p["pg_id"])
            if pg["state"] == "CREATED":
                acq = pg.pop("_acq", None)
                for idx, (node_id, bundle) in enumerate(
                        zip(pg["nodes"], pg["bundles"])):
                    if recovering and (acq is None or idx not in acq):
                        # post-restart: this bundle was never re-acquired —
                        # releasing it would overcommit the node
                        continue
                    if node_id in self._nodes and self._nodes[node_id].alive:
                        self.cluster.release(node_id, bundle)
            # the actors placed in its bundles go with it (the reference's
            # remove_placement_group kills them; the JAX package's head
            # leaves them running on resources no bundle holds any more)
            placed = [aid for aid, e in self._actors.items()
                      if e.pg is not None and e.pg[0] == p["pg_id"]
                      and e.state != DEAD]
        for actor_id in placed:
            self._h_kill_actor({"actor_id": actor_id, "no_restart": True},
                               ctx)
        self._try_schedule_pgs()
        return True

    def _h_get_pg(self, p, ctx):
        with self._lock:
            pg = self._pgs.get(p["pg_id"])
            if pg is None:
                return None
            return dict(pg)

    # ------------------------------------------------------------------ state

    def _h_cluster_resources(self, p, ctx):
        with self._lock:
            total: Dict[str, float] = {}
            for n in self._nodes.values():
                if not n.alive:
                    continue
                for k, v in n.resources.items():
                    total[k] = total.get(k, 0.0) + v
            return total

    def _pooled_fast_keys(self) -> set:
        """fast_keys of grants sitting UN-HELD in the C pool — their
        resources are reclaimable in one drain, so capacity reports treat
        them as free (without this, pooled grants masked freed capacity
        from the elastic-train grow monitor and the autoscaler)."""
        if not self._fast_lease_on:
            return set()
        try:
            return set(self.server.lease_pooled_keys())
        except Exception:  # noqa: BLE001
            return set()

    def _h_available_resources(self, p, ctx):
        total = self._h_cluster_resources(p, ctx)
        pooled = self._pooled_fast_keys()
        with self._lock:
            for lease in self._leases.values():
                if lease.fast_key is not None and lease.fast_key in pooled:
                    continue  # grantable pool cache counts as available
                for k, v in lease.resources.items():
                    total[k] = total.get(k, 0.0) - v
            for e in self._actors.values():
                if e.state in (ALIVE, PENDING, RESTARTING) and e.node_id:
                    for k, v in e.resources.items():
                        total[k] = total.get(k, 0.0) - v
        return total

    #: snapshots older than this are from dead/departed workers: drop
    #: them from aggregation and prune the map (bounds growth under
    #: worker churn; ~12 missed export periods at the default 5s)
    METRICS_STALE_S = 60.0

    def _h_telemetry_push(self, p, ctx):
        with self._lock:
            if p.get("metrics"):
                self._metrics[p["worker"]] = {
                    "ts": time.time(), "snap": p["metrics"]}
            if p.get("objects") is not None:
                # per-owner object summary for `list objects` (reference:
                # the state API's object listing aggregates owner-side
                # ref tables — ownership model: owners are authoritative)
                self._objects[p["worker"]] = {
                    "ts": time.time(), "node": p.get("node", ""),
                    "role": p.get("role", ""), "snap": p["objects"]}
            for e in p.get("events", ()):
                e["worker"] = p["worker"][:12]
                e["node"] = p.get("node", "")
                self._task_events.append(e)
            for r in p.get("llm_requests", ()):
                rid = r.get("rid")
                if not rid:
                    continue
                # live snapshots re-ship every flush and overwrite; a
                # landed FINISHED record is final — never let a stale
                # in-flight snapshot (reordered flush) roll it back
                cur = self._llm_requests.get(rid)
                if cur is not None and cur.get("done") \
                        and not r.get("done"):
                    continue
                r["worker"] = p["worker"][:12]
                r["node"] = p.get("node", "")
                self._llm_requests[rid] = r
                self._llm_requests.move_to_end(rid)
                while len(self._llm_requests) > self._llm_requests_cap:
                    self._llm_requests.popitem(last=False)
        if p.get("samples"):
            # hardware gauges -> ring buffers (own lock; outside _lock so
            # a big batch never stalls lease/actor RPCs)
            self._timeseries.ingest(p.get("node") or p["worker"],
                                    p["samples"])
        if p.get("profiles"):
            # collapsed-stack windows -> per-process profile rings (own
            # lock, outside _lock for the same reason)
            self._profiles.ingest(
                p["worker"], p["profiles"], role=p.get("role", ""),
                node=(p.get("node") or "")[:12], worker=p["worker"][:12])
        if p.get("logs"):
            # structured log windows -> per-process severity rings (own
            # lock, outside _lock; seq assigned at arrival is the
            # logs_dump follow cursor)
            self._logs.ingest(
                p["worker"], p["logs"], role=p.get("role", ""),
                node=(p.get("node") or "")[:12], worker=p["worker"][:12])
        if p.get("compiles"):
            # XLA compile windows -> per-process rings (own lock,
            # outside _lock; seq assigned at arrival is the
            # compiles_dump follow cursor)
            self._compiles.ingest(
                p["worker"], p["compiles"], role=p.get("role", ""),
                node=(p.get("node") or "")[:12], worker=p["worker"][:12])
        for ev in p.get("journal", ()):
            # worker-originated cluster events (spill overflows): the
            # journal assigns seq/ts at arrival so ordering is the head's
            if isinstance(ev, dict) and ev.get("type"):
                ev = dict(ev)
                etype = ev.pop("type")
                trace_id = ev.pop("trace_id", "")
                ev.setdefault("worker", p["worker"][:12])
                self.journal.record(etype, trace_id=trace_id, **ev)
        return True

    def _h_events_dump(self, p, ctx):
        """Cluster event journal dump (filters: after_seq cursor for
        --follow, exact type, newest-N limit)."""
        p = p or {}
        return self.journal.dump(
            after_seq=int(p.get("after_seq", 0) or 0),
            type=p.get("type", ""),
            limit=int(p.get("limit", 0) or 0))

    def _h_journal_record(self, p, ctx):
        """Out-of-band journal append for trusted controllers (the
        autoscaler records its scaling decisions through this)."""
        p = dict(p or {})
        etype = p.pop("type", "") or "event"
        trace_id = p.pop("trace_id", "")
        return self.journal.record(etype, trace_id=trace_id, **p)["seq"]

    # ------------------------------------------------------------ profiles

    @staticmethod
    def _proc_row(key, role, node, worker, export):
        e = export or {}
        return {"key": key, "role": role, "node": node, "worker": worker,
                "pid": e.get("pid"), "ts": e.get("ts"),
                "samples": int(e.get("samples") or 0),
                "dropped": int(e.get("dropped") or 0),
                "window_s": float(e.get("window_s") or 0.0),
                "stacks": e.get("stacks") or {}}

    def _h_profiles_dump(self, p, ctx):
        """Merged per-process collapsed-stack profiles from the
        ProfileStore (filters: role/node/worker substring, top-N
        stacks per process)."""
        p = p or {}
        try:
            # the head drains its OWN continuous profile at read time —
            # unlike workers/nodes it has no telemetry flush to ride
            export = self._profiler_mod.drain_export()
            if export:
                self._profiles.ingest("head", export, role="head")
        except Exception:  # noqa: BLE001 — profiling never fails a dump
            pass
        return self._profiles.dump(
            role=p.get("role", ""), node=p.get("node", ""),
            worker=p.get("worker", ""), top=int(p.get("top", 0) or 0))

    def _h_logs_dump(self, p, ctx):
        """Merged structured log records from the LogStore (filters:
        role/node/worker substring, severity floor, since-ts, msg regex,
        trace/request-id substring; after_seq cursor for --follow —
        same shape as events_dump)."""
        p = p or {}
        try:
            # the head drains its OWN ring (and staged storm events) at
            # read time — unlike workers/nodes it has no telemetry
            # flush to ride (same contract as _h_profiles_dump)
            export = self._log_plane_mod.drain_export()
            if export:
                self._logs.ingest("head", export, role="head")
            for ev in self._log_plane_mod.drain_journal_events():
                etype = ev.pop("type", "") or "log_error_storm"
                self.journal.record(etype, **ev)
        except Exception:  # noqa: BLE001 — logging never fails a dump
            pass
        return self._logs.dump(
            after_seq=int(p.get("after_seq", 0) or 0),
            role=p.get("role", ""), node=p.get("node", ""),
            worker=p.get("worker", ""), level=p.get("level", ""),
            since=float(p.get("since", 0.0) or 0.0),
            grep=p.get("grep", ""), trace=p.get("trace", ""),
            request=p.get("request", ""),
            limit=int(p.get("limit", 0) or 0))

    def _h_compiles_dump(self, p, ctx):
        """Merged XLA compile records from the CompileStore (filters:
        role/node/worker/callable substring, recompiles-only;
        after_seq cursor for --watch; optional per-callable
        aggregation for --by-callable — same cursor contract as
        logs_dump)."""
        p = p or {}
        try:
            # the head drains its OWN tracker (and staged storm events)
            # at read time — unlike workers/nodes it has no telemetry
            # flush to ride (same contract as _h_logs_dump). Inert in
            # practice: the head never imports jax.
            export = self._compile_mod.drain_export()
            if export:
                self._compiles.ingest("head", export, role="head")
            for ev in self._compile_mod.drain_journal_events():
                etype = ev.pop("type", "") or "compile_storm"
                self.journal.record(etype, **ev)
        except Exception:  # noqa: BLE001 — tracking never fails a dump
            pass
        return self._compiles.dump(
            after_seq=int(p.get("after_seq", 0) or 0),
            role=p.get("role", ""), node=p.get("node", ""),
            worker=p.get("worker", ""),
            callable=p.get("callable", ""),
            recompiles_only=bool(p.get("recompiles_only")),
            limit=int(p.get("limit", 0) or 0),
            by_callable=bool(p.get("by_callable")))

    def _h_profiles_record(self, p, ctx):
        """On-demand burst capture fanned out cluster-wide ('profile
        --record S --hz N'): the head bursts itself while every selected
        node daemon bursts itself and its workers in parallel. Returns
        merged per-process rows in the profiles_dump shape, bypassing
        the store (a burst is a one-shot answer, not history)."""
        p = p or {}
        seconds = max(0.1, min(float(p.get("seconds", 2.0) or 2.0), 30.0))
        hz = float(p.get("hz", 99.0) or 99.0)
        role = p.get("role", "")
        node_f = p.get("node", "")
        worker_f = p.get("worker", "")
        with self._lock:
            nodes = [(n.node_id, n.address)
                     for n in self._nodes.values() if n.alive]
        futs = []
        if role in ("", "node", "worker"):
            payload = {"seconds": seconds, "hz": hz, "worker": worker_f,
                       "include_self": role in ("", "node")
                       and not worker_f,
                       "include_workers": role in ("", "worker")}
            for node_id, addr in nodes:
                if node_f and not node_id.startswith(node_f):
                    continue
                try:
                    futs.append(self._node_clients.get(addr).call_async(
                        "profile_burst", payload))
                except Exception:  # noqa: BLE001 — node dying mid-record
                    pass
        procs = []
        if role in ("", "head") and not node_f and not worker_f:
            from ray_tpu_torch.util.stack_profiler import burst_capture
            procs.append(self._proc_row(
                "head", "head", "", "", burst_capture(seconds, hz)))
        for fut in futs:
            try:
                reply = fut.result(timeout=seconds + 15.0)
            except Exception:  # noqa: BLE001 — skip unreachable nodes
                continue
            for row in (reply or {}).get("procs", ()):
                procs.append(self._proc_row(
                    row.get("key", ""), row.get("role", ""),
                    row.get("node", ""), row.get("worker", ""),
                    row.get("export")))
        return {"procs": procs}

    def _h_objects_dump(self, p, ctx):
        """Aggregated object directory: every reporter's reconciled rows
        (stamped with node + reporter) plus per-node, per-role totals
        summed over ALL entries — exact against ShmStore ground truth
        even when per-reporter rows were truncated."""
        cutoff = time.time() - self.METRICS_STALE_S
        with self._lock:
            for w in [w for w, e in self._objects.items()
                      if e["ts"] < cutoff]:
                del self._objects[w]
            reporters = [(w, e) for w, e in self._objects.items()]
        rows: List[dict] = []
        totals: Dict[str, dict] = {}
        for w, e in reporters:
            for row in (e["snap"].get("dir") or ()):
                rows.append({"node": e["node"], "reporter": w[:12], **row})
            for role, t in (e["snap"].get("dir_totals") or {}).items():
                node_tot = totals.setdefault(e["node"], {})
                cur = node_tot.setdefault(
                    role, {"count": 0, "bytes": 0, "arena_bytes": 0})
                cur["count"] += t.get("count", 0)
                cur["bytes"] += t.get("bytes", 0)
                cur["arena_bytes"] += t.get("arena_bytes", 0)
        return {"rows": rows, "totals": totals}

    def _h_metrics_dump(self, p, ctx):
        from ray_tpu_torch.util.metrics import aggregate
        cutoff = time.time() - self.METRICS_STALE_S
        with self._lock:
            for w in [w for w, e in self._metrics.items()
                      if e["ts"] < cutoff]:
                del self._metrics[w]
            per_worker = {w: dict(e["snap"])
                          for w, e in self._metrics.items()}
        agg = aggregate(per_worker)
        if p and p.get("raw"):
            # tuple keys intact — the Prometheus renderer needs tag
            # structure, and pickle-path callers carry tuples fine
            return agg
        # tuple tag keys -> joined strings for wire/json friendliness
        for m in agg.values():
            m["values"] = {"|".join(k) if isinstance(k, tuple) else str(k): v
                           for k, v in m["values"].items()}
        return agg

    def _h_timeseries_dump(self, p, ctx):
        """Hardware ring-buffer dump (filters: node prefix, exact metric,
        last N points per series; latest=True -> newest point only)."""
        p = p or {}
        if p.get("latest"):
            return self._timeseries.latest(
                max_age_s=p.get("max_age_s", 0.0))
        return self._timeseries.dump(node=p.get("node", ""),
                                     metric=p.get("metric", ""),
                                     last=int(p.get("last", 0) or 0))

    def _h_timeline_dump(self, p, ctx):
        with self._lock:
            return list(self._task_events)

    def _h_requests_dump(self, p, ctx):
        """LLM request records aggregated from engine flight recorders
        (filters: live=True -> in-flight only; request=<rid> -> one
        record; slowest=N -> N worst finished e2e latencies first)."""
        p = p or {}
        with self._lock:
            recs = list(self._llm_requests.values())
        rid = p.get("request")
        if rid:
            return [r for r in recs if r.get("rid") == rid]
        if p.get("live"):
            recs = [r for r in recs if not r.get("done")]
        n = int(p.get("slowest", 0) or 0)
        if n > 0:
            recs = sorted(recs, key=lambda r: r.get("e2e") or 0.0,
                          reverse=True)[:n]
        return recs

    def _h_autoscaler_state(self, p, ctx):
        """Demand + per-node busyness for the autoscaler reconciler
        (reference: gcs_autoscaler_state_manager.h cluster state reply)."""
        horizon = time.time() - p.get("demand_window_s", 10.0)
        pooled = self._pooled_fast_keys()
        with self._lock:
            for k in [k for k, d in self._demand.items()
                      if d["ts"] < horizon]:
                del self._demand[k]
            demand = []
            for d in self._demand.values():
                # one shape per pending task, capped (a deep queue should
                # not request more nodes than it can use at once)
                demand.extend([dict(d["resources"])] *
                              min(d["count"], 16))
            # Unplaced placement-group bundles are demand too — the TPU
            # gang path: a pending {TPU-{pod}-head: 1} bundle asks the
            # autoscaler for a whole slice (reference:
            # gcs_autoscaler_state_manager reports pending gang requests)
            for pg in self._pgs.values():
                if pg["state"] == "PENDING":
                    demand.extend(dict(b) for b in pg["bundles"])
            busy_nodes = set()
            for lease in self._leases.values():
                if lease.fast_key is not None and lease.fast_key in pooled:
                    continue  # pooled cache must not block idle drain
                busy_nodes.add(lease.node_id)
            for e in self._actors.values():
                if e.state in (ALIVE, PENDING, RESTARTING) and e.node_id:
                    busy_nodes.add(e.node_id)
            # a CREATED placement group is a live reservation: its nodes
            # must never be idle-drained out from under it
            for pg in self._pgs.values():
                if pg["state"] == "CREATED":
                    busy_nodes.update(pg.get("nodes") or ())
            nodes = [{"node_id": n.node_id, "alive": n.alive,
                      "address": n.address,
                      "resources": n.resources,
                      "busy": n.node_id in busy_nodes}
                     for n in self._nodes.values()]
        return {"demand": demand, "nodes": nodes}

    def _h_state_dump(self, p, ctx):
        cutoff = time.time() - self.METRICS_STALE_S
        with self._lock:
            for w in [w for w, e in self._objects.items()
                      if e["ts"] < cutoff]:
                del self._objects[w]
            objects = [
                {"owner": w[:12], "node": e["node"], "role": e["role"],
                 **{k: v for k, v in e["snap"].items()
                    if k not in ("dir", "dir_totals")}}
                for w, e in self._objects.items()]
            # flattened per-object directory rows (the `ray memory` /
            # state.list_objects() surface; full totals via objects_dump)
            objects_dir = [
                {"node": e["node"], "reporter": w[:12], **row}
                for w, e in self._objects.items()
                for row in (e["snap"].get("dir") or ())]
            tasks = list(self._task_events)[-int(p.get("task_limit", 200)
                                                if p else 200):]
            return {
                "tasks": tasks,
                "objects": objects,
                "objects_dir": objects_dir,
                "events": self.journal.stats(),
                "nodes": [{"node_id": n.node_id, "address": n.address,
                           "alive": n.alive, "resources": n.resources}
                          for n in self._nodes.values()],
                "actors": [{"actor_id": aid.hex(), "class": e.class_name,
                            "state": e.state, "node_id": e.node_id,
                            "name": e.name_key, "restarts": e.num_restarts,
                            "reason": e.reason}
                           for aid, e in self._actors.items()],
                "leases": len(self._leases),
                "fast_lease": (self.server.lease_stats()
                               if self._fast_lease_on else None),
                "placement_groups": [
                    {"pg_id": pid.hex(), "strategy": pg["strategy"],
                     "nodes": pg["nodes"], "name": pg["name"]}
                    for pid, pg in self._pgs.items()],
            }

    def stop(self) -> None:
        self._stopped.set()
        if self._persist_path:
            try:
                self._save_snapshot()
            except Exception:  # noqa: BLE001
                pass
        self.server.stop()
        self._node_clients.close_all()


def main() -> None:
    """Entrypoint: ``python -m ray_tpu_torch.runtime.head <port> <session>``."""
    import signal

    port = int(sys.argv[1])
    session = sys.argv[2]
    if len(sys.argv) > 3:
        config_mod.GlobalConfig.apply(json.loads(sys.argv[3]))
    persist = sys.argv[4] if len(sys.argv) > 4 else ""
    head = Head(port=port, session=session, persist_path=persist)
    stop = threading.Event()

    def _term(*_):
        head.stop()
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    sys.stdout.write(f"RTPT_HEAD_READY {head.address}\n")
    sys.stdout.flush()
    try:
        while not stop.wait(3600):
            pass
    except KeyboardInterrupt:
        head.stop()


if __name__ == "__main__":
    main()
