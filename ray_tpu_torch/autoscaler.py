"""Autoscaler: reconcile cluster capacity against pending demand.

Role-equivalent to the reference's autoscaler v2 reconciler (reference:
autoscaler/v2/instance_manager/instance_manager.py:29 +
v2/scheduler.py:624 ResourceDemandScheduler; the head reports demand the
way gcs_autoscaler_state_manager.h does): a loop polls the head for
unserviceable lease shapes and per-node busyness, bin-packs demand onto
a CATALOG of node types (reference:
autoscaler/_private/resource_demand_scheduler.py:102 — a real fleet
mixes CPU-only head/data hosts with GPU hosts), launches
nodes through pluggable NodeProviders, and terminates nodes idle beyond
the timeout — each type scaling independently.

Every launch is an ``InstanceRecord`` driven through the
REQUESTED→ALLOCATED→RUNNING→DRAINING→TERMINATED state machine of
``runtime/instance_manager.py`` — persisted in the head's KV table and
journaled per transition — instead of the ad-hoc process-local
``_pending``/``_launched`` dicts this module used to keep. That makes
the loop crash-consistent: SIGKILL the autoscaler mid-launch, restart
it, and the first reconcile pass re-adopts nodes that registered while
it was down and terminates unadopted launch orphans through the
provider's own live-handle ledger, leaking nothing.

``LocalNodeProvider`` launches node daemons as local subprocesses — the
reference's fake_multi_node provider trick (SURVEY §4 item 3) promoted to
the first-class test/dev provider; its append-only ledger file is the
durable record of which pids it owns, and the default provider of every
node type. The cloud provider is
``ray_tpu_torch.providers.gce_gpu.GceGpuNodeProvider``: one Compute
Engine A3 (H100) VM per node through the GCE REST API (HTTP transport
injectable: tests exercise it against a fake), used through
``NodeTypeSpec(provider=...)`` or ``Autoscaler(provider)``.

The port of ``ray_tpu/autoscaler.py``. A node ``LocalNodeProvider``
launches advertises the cards its type names and none otherwise
(``"GPU"`` is always passed to the daemon, which would count the
machine's cards itself): on a one-card machine, a CPU node type must not
advertise the card a GPU node type holds.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.runtime import instance_manager as im
from ray_tpu_torch.runtime.protocol import RpcClient, RpcError
from ray_tpu_torch.util.fault_injector import fire

logger = logging.getLogger("ray_tpu_torch.autoscaler")


class NodeProvider:
    """Launch/terminate nodes (reference: autoscaler/node_provider.py).

    Contract: ``create_node`` must stamp the returned handle with an
    ``rtpu_node_id`` attribute — the node id the launched daemon will
    register under. The autoscaler adopts registrations by that identity,
    so a manual join racing an in-flight launch is never mistaken for an
    autoscaler-owned node (and never idle-terminated). Callers may pass
    the ``node_id`` themselves (the autoscaler does, so the identity is
    persisted in an instance record BEFORE the provider call).

    The three reconcile hooks make crash recovery possible without a
    live in-process handle: ``describe`` returns the durable metadata a
    record persists (pid, cloud resource name), ``list_live`` reports
    everything the provider currently owns (the live-handle ledger the
    no-leak tests assert against), and ``terminate_orphan`` releases an
    instance located only by that metadata.
    """

    def create_node(self, resources: Dict[str, float],
                    node_id: Optional[str] = None) -> Any:
        raise NotImplementedError

    def terminate_node(self, handle: Any) -> None:
        raise NotImplementedError

    def describe(self, handle: Any) -> Dict[str, Any]:
        """Durable metadata locating ``handle`` across a restart."""
        return {}

    def list_live(self) -> Dict[str, Dict[str, Any]]:
        """node_id -> metadata for every instance the provider still
        owns. Default: unknown (providers without a ledger)."""
        return {}

    def terminate_orphan(self, node_id: str,
                         metadata: Dict[str, Any]) -> None:
        """Release an instance by persisted metadata (no handle)."""


class LocalNodeProvider(NodeProvider):
    """Nodes are local subprocess daemons joined to the head.

    Keeps an append-only jsonl ledger (``create``/``terminate`` ops with
    pids) next to the session so a restarted autoscaler — or a test —
    can enumerate exactly which daemons the provider still owns:
    ``list_live`` replays the ledger and filters by pid liveness. The
    ledger line is written synchronously inside ``create_node``, which
    closes the crash window between "subprocess spawned" and "ALLOCATED
    record persisted" — the pid is on disk before create_node returns.
    """

    def __init__(self, head_addr: str, session: str,
                 ledger_path: Optional[str] = None):
        self.head_addr = head_addr
        self.session = session
        import tempfile
        self.ledger_path = ledger_path or os.path.join(
            tempfile.gettempdir(), f"rtpt-provider-{session}.ledger")

    def _ledger_append(self, op: str, node_id: str, pid: int) -> None:
        with open(self.ledger_path, "a", encoding="utf-8") as f:
            f.write(json.dumps({"op": op, "node_id": node_id,
                                "pid": pid}) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def create_node(self, resources: Dict[str, float],
                    node_id: Optional[str] = None):
        from ray_tpu_torch.core.ids import NodeID
        from ray_tpu_torch.runtime.cluster_backend import start_node
        fire("provider.create")
        node_id = node_id or NodeID.from_random().hex()
        proc = start_node(self.head_addr, self.session,
                          resources={"GPU": 0.0, **resources},
                          node_id=node_id)
        self._ledger_append("create", node_id, proc.pid)
        proc.rtpu_node_id = node_id
        return proc

    def terminate_node(self, handle) -> None:
        fire("provider.terminate")
        try:
            handle.terminate()
            handle.wait(timeout=5.0)
        except Exception:  # noqa: BLE001
            try:
                handle.kill()
            except Exception:  # noqa: BLE001
                pass
        nid = getattr(handle, "rtpu_node_id", None)
        if nid is not None:
            self._ledger_append("terminate", nid, handle.pid)

    def describe(self, handle) -> Dict[str, Any]:
        return {"pid": handle.pid}

    def _replay_ledger(self) -> Dict[str, int]:
        """node_id -> pid for created-but-not-terminated entries."""
        owned: Dict[str, int] = {}
        try:
            with open(self.ledger_path, encoding="utf-8") as f:
                for line in f:
                    try:
                        e = json.loads(line)
                    except ValueError:
                        continue  # torn final line from a crash
                    if e.get("op") == "create":
                        owned[e["node_id"]] = int(e["pid"])
                    elif e.get("op") == "terminate":
                        owned.pop(e.get("node_id"), None)
        except FileNotFoundError:
            pass
        return owned

    @staticmethod
    def _pid_alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
        except (ProcessLookupError, PermissionError):
            return False
        return True

    def list_live(self) -> Dict[str, Dict[str, Any]]:
        return {nid: {"pid": pid}
                for nid, pid in self._replay_ledger().items()
                if self._pid_alive(pid)}

    def terminate_orphan(self, node_id: str,
                         metadata: Dict[str, Any]) -> None:
        import signal
        fire("provider.terminate")
        pid = metadata.get("pid") or self._replay_ledger().get(node_id)
        if pid is None:
            return  # never made it to the ledger: nothing to release
        try:
            os.kill(int(pid), signal.SIGTERM)
            for _ in range(50):
                if not self._pid_alive(int(pid)):
                    break
                time.sleep(0.1)
            else:
                os.kill(int(pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        self._ledger_append("terminate", node_id, int(pid))


@dataclasses.dataclass
class NodeTypeSpec:
    """One entry of the node-type catalog (reference: the available_node_
    types table resource_demand_scheduler bin-packs over,
    resource_demand_scheduler.py:102). ``provider=None`` uses the
    Autoscaler's default provider (``LocalNodeProvider`` in ``main`` and
    ``AutoscalingCluster``)."""

    resources: Dict[str, float]
    max_workers: int = 4
    min_workers: int = 0
    provider: Optional[NodeProvider] = None


class Autoscaler:
    """The reconcile loop over a node-type catalog.

    ``node_types`` maps type name -> NodeTypeSpec; the single-type
    ``node_type=`` shorthand wraps into a one-entry catalog. Demand
    bin-packs across the catalog best-fit (least normalized leftover), so
    a CPU-task backlog launches CPU hosts while a pending ``{"GPU": 1}``
    bundle launches exactly the GPU type that fits it.

    All launch state lives in ``self.im`` (an InstanceManager persisting
    through the head's KV table); on the first reconcile pass after a
    (re)start the persisted records are replayed against the head's node
    table and each provider's ledger, converging to zero orphans.
    """

    def __init__(self, head_addr: str, provider: Optional[NodeProvider]
                 = None, *,
                 node_type: Optional[Dict[str, float]] = None,
                 node_types: Optional[Dict[str, NodeTypeSpec]] = None,
                 max_workers: int = 4, min_workers: int = 0,
                 idle_timeout_s: float = 10.0,
                 poll_period_s: float = 1.0):
        self.head = RpcClient(head_addr, name="autoscaler")
        self.provider = provider
        if node_types is None:
            node_types = {"default": NodeTypeSpec(
                dict(node_type or {"CPU": 1.0}), max_workers=max_workers,
                min_workers=min_workers)}
        self.node_types = dict(node_types)
        for name, spec in self.node_types.items():
            if spec.provider is None and provider is None:
                raise ValueError(f"node type {name!r} has no provider and "
                                 f"no default was given")
        self.idle_timeout_s = idle_timeout_s
        self.poll_period_s = poll_period_s
        self._stop = threading.Event()
        self.im = im.InstanceManager(
            im.KvInstanceStore(self.head), journal=self._journal)
        self._type_of: Dict[str, str] = {}  # node_id -> type (records own
        #                                     it too; this is a hot cache)
        self._foreign: set = set()        # nodes we did NOT launch
        self._idle_since: Dict[str, float] = {}
        # restart reconcile stays due until no launch is left in the
        # ambiguous young-orphan window
        self._restart_reconcile_due = True
        self._thread: Optional[threading.Thread] = None

    def _provider_for(self, tname: str) -> NodeProvider:
        spec = self.node_types.get(tname)
        return (spec.provider if spec and spec.provider is not None
                else self.provider)

    @property
    def _handles(self) -> List[Any]:
        """Compatibility view: ``[(type_name, provider_handle)]`` for
        every live launch that still has an in-process handle."""
        return [(r.node_type, r.handle) for r in self.im.records()
                if r.live and r.handle is not None]

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # join BEFORE terminating: an in-flight reconcile could otherwise
        # launch a node after the cleanup and leak a live daemon
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        for rec in self.im.records():
            if not rec.live:
                continue
            try:
                self._release(rec)
            except Exception:  # noqa: BLE001
                logger.exception("release failed for %s", rec.node_id[:12])
            try:
                self.im.transition(rec.node_id, im.TERMINATED,
                                   detail="autoscaler-stop")
            except Exception:  # noqa: BLE001 — head may already be gone;
                pass  # the provider release above is what prevents leaks
        self.head.close()

    def _release(self, rec) -> None:
        """Release a record's machine through its provider — via the
        in-process handle when we have one, else by persisted metadata
        (an adopted-after-restart or orphaned record)."""
        prov = self._provider_for(rec.node_type)
        if prov is None:
            prov = self.provider
        if prov is None:
            return
        if rec.handle is not None:
            prov.terminate_node(rec.handle)
        else:
            prov.terminate_orphan(rec.node_id, rec.metadata)

    # ------------------------------------------------------------ reconcile

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_period_s):
            try:
                self._reconcile_once()
            except Exception:  # noqa: BLE001 — reconciler must survive
                logger.exception("autoscaler iteration failed")

    def _reconcile_once(self) -> None:
        try:
            state = self.head.call("autoscaler_state",
                                   {"demand_window_s": 5.0}, timeout=10)
        except RpcError:
            return
        if self._restart_reconcile_due:
            self._restart_reconcile(state["nodes"])
        self._adopt_registered(state["nodes"])
        live = self.im.live_counts()
        need = self._nodes_needed(state["demand"], live)
        # a type below its min_workers floor launches even with zero
        # demand — the floor is what makes "always keep one warm GPU host"
        # (and driverless lifecycle tests) expressible
        for tname, spec in self.node_types.items():
            deficit = spec.min_workers - live.get(tname, 0)
            if deficit > need.get(tname, 0):
                need[tname] = deficit
        for tname, count in need.items():
            spec = self.node_types[tname]
            up = min(count, spec.max_workers - live.get(tname, 0))
            for _ in range(max(0, up)):
                if self._stop.is_set():
                    return
                self._launch(tname, spec)
        # Busy nodes reset their idle clock regardless of which types
        # are draining this pass — a stale timestamp from an earlier
        # idle spell would otherwise terminate a node the instant its
        # NEXT idle spell begins
        for n in state["nodes"]:
            if n.get("busy"):
                self._idle_since.pop(n["node_id"], None)
        # Per-type drain: a type with no serviceable pending demand
        # shrinks even while OTHER types are scaling up (an idle GPU
        # host must not be kept hot by a CPU-task backlog). Demand a
        # type can never satisfy (an infeasible gang bundle) must NOT
        # block its drain forever, hence need==0 rather than
        # raw-demand-empty.
        quiet = [t for t in self.node_types if need.get(t, 0) == 0]
        if quiet:
            self._scale_down(state["nodes"], quiet)

    def _launch(self, tname: str, spec: NodeTypeSpec) -> None:
        """One provider launch, driven through the state machine: the
        REQUESTED record (with the node identity the daemon will register
        under) is persisted BEFORE create_node — a crash at any point
        leaves a reconcilable record, never an untracked machine."""
        from ray_tpu_torch.core.ids import NodeID
        node_id = NodeID.from_random().hex()
        logger.info("autoscaler: launching %s node %s", tname,
                    spec.resources)
        rec = self.im.request(tname, dict(spec.resources), node_id)
        self._type_of[node_id] = tname
        fire("autoscaler.pre_create")
        try:
            handle = self._provider_for(tname).create_node(
                dict(spec.resources), node_id=node_id)
        except Exception as exc:  # noqa: BLE001 — quota, API down...
            logger.exception("create_node failed for type %s", tname)
            self.im.transition(node_id, im.LAUNCH_FAILED,
                               detail="create_node-raised",
                               error=repr(exc))
            return
        rec.handle = handle
        fire("autoscaler.post_create")
        self.im.transition(
            node_id, im.ALLOCATED,
            metadata=self._provider_for(tname).describe(handle))
        self._journal("autoscaler_scale_up", trace_id=rec.trace_id,
                      node_type=tname, node_id=node_id,
                      resources=dict(spec.resources))

    def _restart_reconcile(self, nodes: List[dict]) -> None:
        """Crash-consistent convergence after a (re)start: replay
        persisted records and each provider's ledger against the head's
        node table. Stays due while any launch sits in the young-orphan
        grace window (it could still register), re-running until the
        table is unambiguous — reconcile itself is idempotent."""
        from ray_tpu_torch.core.config import GlobalConfig
        restored = self.im.load()
        for rec in self.im.records():
            self._type_of.setdefault(rec.node_id, rec.node_type)
        registered = {n["node_id"] for n in nodes if n.get("alive")}
        provider_live: Dict[str, Dict[str, Any]] = {}
        providers = {id(p): p for p in
                     [self.provider] + [s.provider
                                        for s in self.node_types.values()]
                     if p is not None}
        for prov in providers.values():
            try:
                provider_live.update(prov.list_live() or {})
            except Exception:  # noqa: BLE001
                logger.exception("provider list_live failed")
        actions = self.im.reconcile(
            registered, provider_live, terminate=self._release,
            orphan_grace_s=GlobalConfig.instance_orphan_grace_s)
        self._restart_reconcile_due = bool(actions["pending"])
        if restored or any(v for k, v in actions.items() if k != "pending"):
            self._journal(
                "autoscaler_restart_reconcile", restored=restored,
                **{k: len(v) for k, v in actions.items()})

    def _journal(self, etype: str, trace_id: str = "", **fields) -> None:
        """Record a scaling decision in the head's cluster event journal
        (reference: autoscaler events in `ray status`/the GCS event log).
        Best-effort: journaling must never break reconciliation."""
        try:
            payload = {"type": etype, **fields}
            if trace_id:
                payload["trace_id"] = trace_id
            self.head.call("journal_record", payload, timeout=5)
        except Exception:  # noqa: BLE001
            pass

    def _adopt_registered(self, nodes: List[dict]) -> None:
        """Drive pending launches to RUNNING once their node registers
        with the head, matched by the launch identity the provider
        stamped (``rtpu_node_id``) — never by arrival order, so a
        foreign node registering mid-launch cannot be adopted and later
        idle-terminated (advisor r2). A launch whose process died before
        ever registering becomes LAUNCH_FAILED — journaled as
        ``node_launch_failed`` with its node_type and exit info, so
        `events` shows the stillbirth instead of a silent log line."""
        known = {n["node_id"] for n in nodes}
        for rec in self.im.records(im.REQUESTED, im.ALLOCATED):
            if rec.node_id in known:
                self.im.transition(rec.node_id, im.RUNNING,
                                   detail="registered")
                continue
            exit_info = None
            if rec.handle is not None:
                exit_info = getattr(rec.handle, "poll", lambda: None)()
            if exit_info is not None:
                logger.warning(
                    "autoscaler: launched %s node %s died pre-register "
                    "(%s)", rec.node_type, rec.node_id[:12], exit_info)
                try:  # dead to us — but still release the provider side
                    self._release(rec)
                except Exception:  # noqa: BLE001
                    pass
                self.im.transition(rec.node_id, im.LAUNCH_FAILED,
                                   detail="died-pre-register",
                                   exit_info=str(exit_info))
        # everything not ours is someone else's node (the static head
        # node, manual joins) — never adopt or terminate those
        mine = {r.node_id for r in self.im.records()}
        self._foreign |= known - mine

    def _nodes_needed(self, demand: List[Dict[str, float]],
                      live: Optional[Dict[str, int]] = None
                      ) -> Dict[str, int]:
        """Bin-pack pending shapes across the node-type catalog
        (reference: resource_demand_scheduler.py:102): shapes first fill
        bins already opened this pass; a shape that fits nowhere opens a
        new bin of the BEST-FIT type (least normalized leftover — a 1-CPU
        task opens a CPU host, not a GPU host), respecting each type's
        max_workers against live+planned counts."""
        need: Dict[str, int] = {}
        if not demand:
            return need
        live = dict(live or {})
        bins: List[Any] = []   # (tname, remaining resources)
        for shape in demand:
            placed = False
            for _, b in bins:
                if all(b.get(k, 0.0) >= v for k, v in shape.items()):
                    for k, v in shape.items():
                        b[k] = b.get(k, 0.0) - v
                    placed = True
                    break
            if placed:
                continue
            best = None
            best_score = None
            for tname, spec in self.node_types.items():
                res = spec.resources
                if any(v > res.get(k, 0.0) for k, v in shape.items()):
                    continue  # can never fit
                if live.get(tname, 0) + need.get(tname, 0) >= \
                        spec.max_workers:
                    continue  # type at capacity
                # normalized leftover: fraction of the node left unused
                score = sum(1.0 - shape.get(k, 0.0) / v
                            for k, v in res.items() if v > 0)
                if best_score is None or score < best_score:
                    best, best_score = tname, score
            if best is None:
                continue  # infeasible everywhere (or everything capped)
            fresh = dict(self.node_types[best].resources)
            for k, v in shape.items():
                fresh[k] = fresh.get(k, 0.0) - v
            bins.append((best, fresh))
            need[best] = need.get(best, 0) + 1
        return need

    def _scale_down(self, nodes: List[dict],
                    types: List[str]) -> None:
        now = time.monotonic()
        by_type: Dict[str, List[dict]] = {t: [] for t in types}
        running = {r.node_id: r for r in self.im.records(im.RUNNING)}
        for n in nodes:
            rec = running.get(n["node_id"])
            if n["alive"] and rec is not None and rec.node_type in by_type:
                by_type[rec.node_type].append(n)
        for tname, alive_mine in by_type.items():
            removable = len(alive_mine) - \
                self.node_types[tname].min_workers
            for n in alive_mine:
                nid = n["node_id"]
                if n["busy"]:
                    self._idle_since.pop(nid, None)
                    continue
                first_idle = self._idle_since.setdefault(nid, now)
                if removable > 0 and \
                        now - first_idle >= self.idle_timeout_s:
                    logger.info("autoscaler: terminating idle %s node %s",
                                tname, nid[:12])
                    rec = running[nid]
                    self._journal("autoscaler_scale_down",
                                  trace_id=rec.trace_id, node_type=tname,
                                  node_id=nid,
                                  idle_s=round(now - first_idle, 1))
                    self.im.transition(nid, im.DRAINING,
                                       idle_s=round(now - first_idle, 1))
                    self._idle_since.pop(nid, None)
                    # drain via the node's own shutdown RPC, addressed by
                    # node_id (handles and node ids were paired by launch
                    # identity, but the daemon exits cleanest by RPC)...
                    drain = RpcClient(n["address"], name="asc-drain")
                    try:
                        drain.call("shutdown", {}, timeout=5.0)
                    except RpcError:
                        pass  # already dead
                    finally:
                        drain.close()
                    # ...then release the underlying machine through the
                    # provider — for a cloud provider this is the API call
                    # that actually stops billing (a local Popen terminate
                    # is an idempotent no-op after the RPC shutdown)
                    try:
                        self._release(rec)
                    except Exception:  # noqa: BLE001
                        logger.exception("terminate_node failed for %s",
                                         nid[:12])
                    self.im.transition(nid, im.TERMINATED,
                                       detail="idle-timeout")
                    removable -= 1


class AutoscalingCluster:
    """Test/dev helper: a cluster whose worker nodes come and go with load
    (reference: cluster_utils.AutoscalingCluster over the fake provider).

    Boots a head + one static head-node, starts an Autoscaler with the
    LocalNodeProvider, and exposes the address to connect a driver. The
    head node advertises the cards ``head_resources`` names, none by
    default. ``node_types`` (a catalog, as ``Autoscaler`` takes it) stands
    in for the one ``worker_node_type``.
    """

    def __init__(self, *, head_resources: Optional[Dict[str, float]] = None,
                 worker_node_type: Optional[Dict[str, float]] = None,
                 max_workers: int = 2, idle_timeout_s: float = 5.0,
                 node_types: Optional[Dict[str, NodeTypeSpec]] = None):
        from ray_tpu_torch.runtime.cluster_backend import start_head, start_node
        self._session = os.urandom(4).hex()
        self._head_proc, self.address = start_head(self._session)
        self._node_proc = start_node(
            self.address, self._session,
            resources={"GPU": 0.0, **(head_resources or {"CPU": 1.0})})
        # wait for the static node to register before a driver connects
        probe = RpcClient(self.address, name="asc-boot")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                if any(n["alive"] for n in probe.call("list_nodes",
                                                      timeout=5)):
                    break
            except RpcError:
                pass
            time.sleep(0.1)
        else:
            raise RuntimeError("head node never registered")
        probe.close()
        self.autoscaler = Autoscaler(
            self.address,
            LocalNodeProvider(self.address, self._session),
            node_type=dict(worker_node_type or {"CPU": 2.0}),
            node_types=node_types,
            max_workers=max_workers,
            idle_timeout_s=idle_timeout_s).start()

    def shutdown(self) -> None:
        self.autoscaler.stop()
        for proc in (self._node_proc, self._head_proc):
            try:
                proc.terminate()
                proc.wait(timeout=5.0)
            except Exception:  # noqa: BLE001
                try:
                    proc.kill()
                except Exception:  # noqa: BLE001
                    pass


def main() -> None:
    """``python -m ray_tpu_torch.autoscaler <head_addr> <json_opts>`` — the
    autoscaler as its own daemon, so lifecycle tests can SIGKILL it
    mid-launch (via RTPT_FAULT_INJECT, inherited through the env) and
    restart it to prove crash-consistent reconcile. Opts::

        {"session": ..., "node_types": {name: {"resources": {...},
         "max_workers": n, "min_workers": n}}, "idle_timeout_s": s,
         "poll_period_s": s, "ledger_path": path, "config": {...}}
    """
    import sys
    from ray_tpu_torch.core import config as config_mod

    head_addr = sys.argv[1]
    opts = json.loads(sys.argv[2]) if len(sys.argv) > 2 else {}
    if opts.get("config"):
        config_mod.GlobalConfig.apply(opts["config"])
    provider = LocalNodeProvider(head_addr, opts.get("session", "default"),
                                 ledger_path=opts.get("ledger_path"))
    node_types = None
    if opts.get("node_types"):
        node_types = {
            name: NodeTypeSpec(dict(sp.get("resources") or {"CPU": 1.0}),
                               max_workers=int(sp.get("max_workers", 4)),
                               min_workers=int(sp.get("min_workers", 0)))
            for name, sp in opts["node_types"].items()}
    scaler = Autoscaler(
        head_addr, provider, node_types=node_types,
        idle_timeout_s=float(opts.get("idle_timeout_s", 10.0)),
        poll_period_s=float(opts.get("poll_period_s", 0.25))).start()
    sys.stdout.write("RTPT_AUTOSCALER_READY\n")
    sys.stdout.flush()
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        scaler.stop()


if __name__ == "__main__":
    main()
