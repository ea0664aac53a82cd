"""Per-process object plane: shm store client + owner protocol + transfer.

Combines the roles of the reference's CoreWorkerPlasmaStoreProvider
(reference: src/ray/core_worker/store_provider/plasma_store_provider.h:88),
the ownership-based object directory (object_manager/
ownership_based_object_directory.h — owners are asked for locations), and
the pull side of the object manager (object_manager/pull_manager.h:53 —
remote objects are fetched from the node daemon holding them and cached in
the local shm store).

Placement policy (reference memory-store/plasma split,
core_worker/store_provider/): serialized values <= memory_store_threshold
stay in the owner's in-process memory store and travel inline over RPC;
larger values are sealed into the node's shared-memory arena and move
node-to-node at most once, then are mapped zero-copy by every local reader.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional, Set, Tuple

from ray_tpu_torch.core import config as config_mod
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core._native import ObjectExists, ObjectStoreFull, ShmStore
from ray_tpu_torch.core.ids import ObjectID, WorkerID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.exceptions import ObjectLostError
from ray_tpu_torch.runtime.protocol import ClientPool, RpcError
from ray_tpu_torch.util import metrics as metrics_mod
from ray_tpu_torch.util import trace_context


def spill_dir_for(session_dir: str, shm_name: str) -> str:
    """Shared per-cluster spill directory (same for every process that
    attaches this shm arena — workers spill, the node daemon serves)."""
    return os.path.join(session_dir, "spill", shm_name.strip("/"))


def spill_file_path(session_dir: str, shm_name: str, oid_hex: str) -> str:
    return os.path.join(spill_dir_for(session_dir, shm_name), oid_hex)


_spill_fs = None


def spill_filesystem():
    """Process-wide storage seam for spill I/O (lazy: daemons import this
    module before metrics are configured). All spill reads/writes ride the
    fault-injectable, retrying filesystem so ``storage.*`` chaos points
    and ``storage_*`` metrics cover the spill path too."""
    global _spill_fs
    if _spill_fs is None:
        from ray_tpu_torch.util.filesystem import storage_filesystem
        _spill_fs = storage_filesystem(None)
    return _spill_fs


def read_spill_file(session_dir: str, shm_name: str,
                    oid_hex: str) -> Optional[bytes]:
    try:
        return spill_filesystem().get(
            spill_file_path(session_dir, shm_name, oid_hex))
    except FileNotFoundError:
        return None
    except Exception:  # noqa: BLE001 — a lost/corrupt spill file reads as
        return None    # absent; callers fall back to lineage reconstruction


class ObjectPlane:
    def __init__(self, worker, local_node_id: str, local_store: ShmStore,
                 head_client, node_addrs: Dict[str, str],
                 node_shm: Dict[str, str]):
        self.worker = worker
        self.local_node_id = local_node_id
        self.store = local_store
        self.head = head_client
        self.node_addrs = dict(node_addrs)     # node_id -> daemon address
        self.node_shm = dict(node_shm)         # node_id -> shm name
        self.locations: Dict[ObjectID, str] = {}   # owned large obj -> node
        # owned obj -> nodes holding secondary (cache) copies; borrowers
        # report in after a pull so later pulls stripe chunks across every
        # holder (reference: OwnershipBasedObjectDirectory location set)
        self.secondary: Dict[ObjectID, set] = {}
        self.owner_addrs: Dict[bytes, str] = {}    # worker_id -> rpc address
        self._peers = ClientPool(name="objplane")
        self._fetching: Set[ObjectID] = set()
        # admission control: bound concurrent large-object pulls so a burst
        # of gets can't open unbounded chunk pipelines (reference:
        # PullManager admission, pull_manager.h:53)
        self._pull_sem = threading.BoundedSemaphore(
            max(1, config_mod.GlobalConfig.object_pull_max_concurrent))
        self._lock = threading.Lock()
        # containment pins: owned object -> refs it contains (release on free)
        self._contained: Dict[ObjectID, list] = {}
        # shared late-delete queue: failed/unroutable delete_object sends
        # coalesce here and ONE drainer retries them after ONE node
        # refresh — a per-failure thread would storm the head exactly
        # when a node dies with many pinned objects on it
        self._late_deletes: list = []   # (node_id, key)
        self._late_thread_live = False
        # --- accounting: per-object directory + spill/pull counters that
        # ride telemetry_push into the head ('python -m ray_tpu_torch memory').
        # Metric instances are cached here so the hot paths pay a plain
        # attribute access, not a registry lookup per event.
        self._acct = bool(config_mod.GlobalConfig.object_accounting)
        self._dir: Dict[ObjectID, dict] = {}   # oid -> size/role/owner/created
        self._journal_pending: list = []       # cluster events awaiting flush
        if self._acct:
            self._m_spill_write_total = \
                metrics_mod.object_store_spill_write_total_counter()
            self._m_spill_write_bytes = \
                metrics_mod.object_store_spill_write_bytes_counter()
            self._m_spill_restore_total = \
                metrics_mod.object_store_spill_restore_total_counter()
            self._m_spill_restore_bytes = \
                metrics_mod.object_store_spill_restore_bytes_counter()
            self._m_pull_in_bytes = \
                metrics_mod.object_store_pull_in_bytes_counter()
            self._m_pull_seconds = \
                metrics_mod.object_store_pull_seconds_histogram()
            self._m_fetch_inflight = \
                metrics_mod.object_store_fetch_inflight_count_gauge()
            self._m_primary_count = \
                metrics_mod.object_store_primary_count_gauge()
            self._m_secondary_count = \
                metrics_mod.object_store_secondary_count_gauge()
            self._m_spilled_count = \
                metrics_mod.object_store_spilled_count_gauge()

    # ------------------------------------------------------------- directory

    def refresh_nodes(self) -> None:
        try:
            for n in self.head.call("list_nodes"):
                self.node_addrs[n["node_id"]] = n["address"]
                self.node_shm[n["node_id"]] = n["shm_name"]
        except RpcError:
            pass

    def node_client(self, node_id: str):
        addr = self.node_addrs.get(node_id)
        if addr is None:
            self.refresh_nodes()
            addr = self.node_addrs.get(node_id)
            if addr is None:
                raise ObjectLostError("", f"unknown node {node_id}")
        return self._peers.get(addr)

    def owner_client(self, owner: WorkerID):
        key = owner.binary()
        addr = self.owner_addrs.get(key)
        if addr is None:
            addr = self.head.call("kv_get", {"key": f"addr:{owner.hex()}"})
            if addr is None:
                raise ObjectLostError("", f"owner {owner.hex()[:12]} unknown")
            self.owner_addrs[key] = addr
        return self._peers.get(addr)

    # ------------------------------------------------------------------- put

    def put_object(self, object_id: ObjectID, value: Any,
                   is_error: bool = False) -> None:
        """Owner-side store: small -> memory store; large -> local shm."""
        so = (serialization.serialize_error(value) if is_error
              else serialization.serialize(value))
        if so.contained_refs:
            # Durable containment borrows replace the transient serialize-
            # time pins (ObjectRef.__reduce__ fired on_ref_serialized).
            self._register_contained(object_id, so.contained_refs)
            for r in so.contained_refs:
                self.worker.refcounter.on_serialized_ref_done(r.id())
        cfg = config_mod.GlobalConfig
        if so.total_bytes <= cfg.memory_store_threshold_bytes:
            self.worker.memory_store.put(object_id, value, is_error=is_error)
            return
        self._seal_local(object_id, so)
        self.locations[object_id] = self.local_node_id
        self.worker.memory_store.mark_in_shm(object_id)

    def _seal_local(self, object_id: ObjectID, so) -> None:
        try:
            buf = self.store.create_object(object_id.binary(), so.total_bytes)
        except ObjectExists:
            return
        except ObjectStoreFull:
            # arena full even after LRU eviction: overflow to disk
            # (reference: LocalObjectManager::SpillObjects — spilled copies
            # restore on demand; see spill_path/_h_read_object fallbacks)
            self._write_spill(object_id, so.to_bytes())
            self._dir_record(object_id, so.total_bytes, "spilled")
            return
        so.write_to(memoryview(buf).cast("B"))
        self.store.seal(object_id.binary())
        self._dir_record(object_id, so.total_bytes, "primary")

    # ---------------------------------------------------------------- spill

    def _spill_dir(self) -> str:
        from ray_tpu_torch.core.config import GlobalConfig
        return spill_dir_for(GlobalConfig.session_dir, self.store.name)

    def _write_spill(self, object_id: ObjectID, data: bytes) -> None:
        # atomic publish + transient-error retry via the storage seam
        spill_filesystem().put(
            os.path.join(self._spill_dir(), object_id.hex()), data)
        if self._acct:
            self._m_spill_write_total.inc()
            self._m_spill_write_bytes.inc(len(data))
            # arena overflow is a cluster-visible condition: queue a
            # journal event for the next telemetry flush, carrying the
            # ambient trace (if any) so `trace` can cross-link it
            ctx = trace_context.current()
            with self._lock:
                if len(self._journal_pending) < 256:
                    self._journal_pending.append({
                        "type": "spill_overflow",
                        "object_id": object_id.hex(),
                        "bytes": len(data),
                        "node": self.local_node_id,
                        "trace_id": ctx[0] if ctx else ""})

    def _read_spill(self, object_id: ObjectID) -> Optional[bytes]:
        from ray_tpu_torch.core.config import GlobalConfig
        data = read_spill_file(GlobalConfig.session_dir, self.store.name,
                               object_id.hex())
        if data is not None and self._acct:
            self._m_spill_restore_total.inc()
            self._m_spill_restore_bytes.inc(len(data))
        return data

    def store_result_bytes(self, object_id: ObjectID, data: bytes,
                           pin: bool = True, owner: str = "") -> str:
        """Seal pre-serialized bytes into local shm.

        ``pin=True`` keeps the creator pin (primary copy — freed by the
        owner's delete path); ``pin=False`` releases it so the copy is an
        LRU-evictable cache (secondary copies from pulls). ``owner`` is
        the owning worker's hex id for the accounting directory (defaults
        to this process — correct for driver puts, overridden when a
        worker seals a return value owned by the submitter). Returns this
        node's id (reported to the owner as the location).
        """
        try:
            buf = self.store.create_object(object_id.binary(), len(data))
            memoryview(buf).cast("B")[:] = data
            self.store.seal(object_id.binary())
            if not pin:
                self.store.release(object_id.binary())
            self._dir_record(object_id, len(data),
                             "primary" if pin else "secondary", owner)
        except ObjectExists:
            pass
        except ObjectStoreFull:
            if pin:
                # primary copy: overflow to disk; the owner's free path
                # (delete_object -> node handler) unlinks it
                self._write_spill(object_id, data)
                self._dir_record(object_id, len(data), "spilled", owner)
            # secondary (cache) copies are NOT spilled: nothing would ever
            # delete them (owner free only reaches the primary node), so
            # they'd leak until node shutdown — callers fall back to the
            # in-memory bytes for the current read instead
        return self.local_node_id

    # ------------------------------------------------------------ accounting

    #: shm_store.cc kAlign — the arena charges align_up(size, 64) per
    #: object, so directory totals report the arena footprint separately
    #: from raw serialized bytes (`bytes_used` ground truth == arena_bytes)
    _ARENA_ALIGN = 64

    def _dir_record(self, object_id: ObjectID, size: int, role: str,
                    owner: str = "") -> None:
        if not self._acct:
            return
        with self._lock:
            self._dir[object_id] = {
                "size": int(size), "role": role,
                "owner": owner or self.worker.worker_id.hex(),
                "created": time.time()}

    def directory_export(self, limit: int = 200) -> dict:
        """Reconciled directory for the telemetry flush: per-object rows
        (largest first, capped at ``limit``) plus EXACT per-role totals
        over all live entries, so head-side byte/count totals stay exact
        even when rows are truncated.

        Reconciliation happens at report time, not event time: a row
        whose shm copy was LRU-evicted (secondaries) or freed behind our
        back is dropped, and a primary that only survives as a spill file
        is demoted to role=spilled — the head table never shows ghosts.
        """
        if not self._acct:
            return {}
        from ray_tpu_torch.core.config import GlobalConfig
        now = time.time()
        with self._lock:
            items = list(self._dir.items())
        rows: list = []
        dead: list = []
        demoted: list = []
        totals: Dict[str, dict] = {}
        align = self._ARENA_ALIGN - 1
        for oid, e in items:
            role, size = e["role"], e["size"]
            spill = spill_file_path(GlobalConfig.session_dir,
                                    self.store.name, oid.hex())
            if role in ("primary", "secondary") \
                    and not self.store.contains(oid.binary()):
                if role == "primary" and os.path.exists(spill):
                    role = "spilled"
                    demoted.append(oid)
                else:
                    dead.append(oid)
                    continue
            elif role == "spilled" and not os.path.exists(spill):
                dead.append(oid)
                continue
            t = totals.setdefault(role,
                                  {"count": 0, "bytes": 0, "arena_bytes": 0})
            t["count"] += 1
            t["bytes"] += size
            if role != "spilled":
                t["arena_bytes"] += (size + align) & ~align
            rows.append({
                "object_id": oid.hex(), "size": size, "role": role,
                "owner": e["owner"][:12],
                "age_s": round(now - e["created"], 3),
                "pins": self.worker.refcounter.counts_for(oid)})
        if dead or demoted:
            with self._lock:
                for oid in dead:
                    self._dir.pop(oid, None)
                for oid in demoted:
                    if oid in self._dir:
                        self._dir[oid]["role"] = "spilled"
        self._m_primary_count.set(
            totals.get("primary", {}).get("count", 0))
        self._m_secondary_count.set(
            totals.get("secondary", {}).get("count", 0))
        self._m_spilled_count.set(
            totals.get("spilled", {}).get("count", 0))
        rows.sort(key=lambda r: -r["size"])
        if limit and len(rows) > limit:
            rows = rows[:limit]
        return {"dir": rows, "dir_totals": totals}

    def drain_journal(self) -> list:
        """Pending cluster events (spill overflows) for telemetry_push."""
        with self._lock:
            out, self._journal_pending = self._journal_pending, []
        return out

    def _register_contained(self, object_id: ObjectID, refs: list) -> None:
        """An owned object embeds other refs: hold borrows until it's freed
        (reference: ReferenceCounter nested-ref tracking,
        reference_count.h:66)."""
        with self._lock:
            self._contained[object_id] = list(refs)
        me = self.worker.worker_id.binary()
        for r in refs:
            if r.owner_id() == self.worker.worker_id:
                self.worker.refcounter.add_borrower(r.id(), me)
                continue
            try:
                self.owner_client(r.owner_id()).call(
                    "add_borrower", {"object_id": r.id().binary(),
                                     "borrower": me})
            except (RpcError, ObjectLostError):
                pass

    # ------------------------------------------------------------------- get

    def record_remote_location(self, object_id: ObjectID, node_id: str) -> None:
        """Owner learns a return value was sealed on some node's shm."""
        self.locations[object_id] = node_id
        self.worker.memory_store.mark_in_shm(object_id)

    def try_resolve(self, ref: ObjectRef) -> bool:
        if self.worker.memory_store.is_ready(ref.id()):
            return True
        if self.store.contains(ref.id().binary()):
            self.worker.memory_store.mark_in_shm(ref.id())
            return True
        return False

    def poke_resolve(self, ref: ObjectRef) -> None:
        """Start an async fetch loop for a ref we don't own locally."""
        if self.try_resolve(ref):
            return
        if ref.owner_id() == self.worker.worker_id:
            return  # we own it; the result will arrive via the reply path
        with self._lock:
            if ref.id() in self._fetching:
                return
            self._fetching.add(ref.id())
            inflight = len(self._fetching)
        if self._acct:
            self._m_fetch_inflight.set(inflight)
        threading.Thread(target=self._fetch_loop, args=(ref,), daemon=True,
                         name="objplane-fetch").start()

    def _fetch_loop(self, ref: ObjectRef) -> None:
        cfg = config_mod.GlobalConfig
        retry_s = cfg.object_pull_retry_ms / 1000.0
        failures = 0
        try:
            while True:
                if self.try_resolve(ref):
                    return
                try:
                    reply = self.owner_client(ref.owner_id()).call(
                        "get_object",
                        {"object_id": ref.id().binary(),
                         "requester": self.worker.worker_id.binary()})
                    failures = 0
                except (RpcError, ObjectLostError):
                    failures += 1
                    if failures >= cfg.rpc_retry_max_attempts:
                        self.worker.memory_store.put(
                            ref.id(),
                            ObjectLostError(ref.hex(), "owner unreachable"),
                            is_error=True)
                        return
                    time.sleep(retry_s)
                    continue
                if reply is None:
                    self.worker.memory_store.put(
                        ref.id(),
                        ObjectLostError(ref.hex(), "owner dropped the object"),
                        is_error=True)
                    return
                if reply.get("pending"):
                    time.sleep(retry_s)
                    continue
                if "inline" in reply:
                    value = serialization.deserialize(reply["inline"])
                    self.worker.memory_store.put(
                        ref.id(), value, is_error=reply.get("is_error", False))
                    return
                if "shm" in reply:
                    try:
                        oneshot = self._pull_to_local(
                            ref.id(), reply["shm"],
                            sources=reply.get("shm_all"),
                            owner=ref.owner_id().hex())
                    except (RpcError, ObjectLostError) as e:
                        # holder node died mid-pull: surface the loss
                        # instead of killing this thread (a silent death
                        # leaves rt.get() hanging forever)
                        self.worker.memory_store.put(
                            ref.id(),
                            ObjectLostError(ref.hex(), f"pull failed: {e}"),
                            is_error=True)
                        return
                    if oneshot is not None:
                        # local arena full — hand the value over directly
                        self.worker.memory_store.put(
                            ref.id(), serialization.deserialize(oneshot))
                        return
                    self._notify_pulled(ref)
                    self.worker.memory_store.mark_in_shm(ref.id())
                    return
        finally:
            with self._lock:
                self._fetching.discard(ref.id())
                inflight = len(self._fetching)
            if self._acct:
                self._m_fetch_inflight.set(inflight)

    def _pull_to_local(self, object_id: ObjectID, node_id: str,
                       sources: Optional[list] = None,
                       owner: str = "") -> Optional[bytes]:
        """Fetch a sealed object from remote node(s) into the local arena
        (reference pull path: pull_manager.h:53 -> ObjectManager::Push).

        Small objects (<= one chunk) ship in a single read_object frame;
        larger objects stream as pipelined fixed-size chunks, striped
        across every node holding a copy, so a multi-GiB object never
        occupies one RPC frame and a broadcast fans out over all holders.

        The local copy is a *secondary* (cache) copy: the creator pin is
        released right away so LRU eviction can reclaim it; the primary
        stays pinned until the owner frees it. If the local arena is too
        full to cache, the fetched bytes are RETURNED so the caller can
        still serve the current read (no disk spill for secondaries — see
        store_result_bytes)."""
        key = object_id.binary()
        if node_id == self.local_node_id or self.store.contains(key):
            return None
        t0 = time.perf_counter()
        srcs = [node_id] + [s for s in (sources or ())
                            if s != node_id and s != self.local_node_id]
        cfg = config_mod.GlobalConfig
        chunk = max(64 * 1024, cfg.object_transfer_chunk_bytes)
        # size probe from the first reachable holder
        info = None
        for i, src in enumerate(srcs):
            try:
                info = self.node_client(src).call(
                    "object_info", {"object_id": key})
            except (RpcError, ObjectLostError):
                continue
            if info is not None:
                srcs = srcs[i:] + srcs[:i]
                break
        if info is None:
            raise ObjectLostError(object_id.hex(), f"gone from {srcs}")
        if info["size"] <= chunk:
            data = self.node_client(srcs[0]).call_retrying(
                "read_object", {"object_id": key})
            if data is None:
                raise ObjectLostError(object_id.hex(),
                                      f"gone from {srcs[0]}")
            if self._acct:
                self._m_pull_in_bytes.inc(len(data))
                self._m_pull_seconds.observe(time.perf_counter() - t0)
            self.store_result_bytes(object_id, data, pin=False, owner=owner)
            if not self.store.contains(key):
                return data  # cache miss (arena full): one-shot bytes
            return None
        with self._pull_sem:
            out = self._pull_chunked(object_id, info["size"], chunk, srcs,
                                     owner)
        if self._acct:
            self._m_pull_seconds.observe(time.perf_counter() - t0)
        return out

    def _pull_chunked(self, object_id: ObjectID, size: int, chunk: int,
                      sources: list, owner: str = "") -> Optional[bytes]:
        cfg = config_mod.GlobalConfig
        key = object_id.binary()
        cached = False
        try:
            buf = self.store.create_object(key, size)
            dest = memoryview(buf).cast("B")
            cached = True
        except ObjectExists:
            # another local process is mid-pull of the same object: wait
            # for its seal instead of double-fetching
            deadline = time.monotonic() + cfg.rpc_call_timeout_s
            while time.monotonic() < deadline:
                if self.store.contains(key):
                    return None
                time.sleep(0.02)
            raise ObjectLostError(object_id.hex(),
                                  "concurrent local pull never sealed")
        except ObjectStoreFull:
            dest = memoryview(bytearray(size))
        try:
            self._fetch_chunks(object_id, size, chunk, sources, dest)
        except BaseException:
            if cached:
                # unsealed + creator-pin release -> native reclaims the
                # half-written allocation instead of leaking arena space
                self.store.release(key)
            raise
        if cached:
            self.store.seal(key)
            self.store.release(key)  # secondary copy: LRU-evictable
            self._dir_record(object_id, size, "secondary", owner)
            return None
        return bytes(dest)

    def _fetch_chunks(self, object_id: ObjectID, size: int, chunk: int,
                      sources: list, dest) -> None:
        """Sliding-window chunk pipeline, striped round-robin across
        holders (reference: PushManager max-chunks-in-flight windowing,
        push_manager.h:30). A failing holder is dropped from rotation and
        its chunks retried from the survivors."""
        from concurrent.futures import FIRST_COMPLETED, wait
        cfg = config_mod.GlobalConfig
        window = max(1, cfg.object_pull_chunk_inflight)
        key = object_id.binary()
        offsets = list(range(0, size, chunk))
        sources = list(sources)
        inflight: Dict[Any, tuple] = {}
        next_i = 0

        def issue(off: int, attempts: int = 0) -> None:
            if not sources:
                raise ObjectLostError(object_id.hex(),
                                      "every holder lost mid-pull")
            src = sources[(off // chunk) % len(sources)]
            ln = min(chunk, size - off)
            fut = self.node_client(src).call_async(
                "read_chunk",
                {"object_id": key, "offset": off, "length": ln})
            inflight[fut] = (off, ln, src, attempts)

        while next_i < len(offsets) and len(inflight) < window:
            issue(offsets[next_i])
            next_i += 1
        while inflight:
            done, _ = wait(list(inflight), return_when=FIRST_COMPLETED,
                           timeout=cfg.rpc_call_timeout_s)
            if not done:
                # A holder's connection is up but its daemon stopped
                # serving: call_async futures only fail on connection loss,
                # so force-fail every client with in-flight chunks. Their
                # futures resolve with RpcError and flow through the normal
                # failover/retry path below (a healthy source's chunks get
                # re-issued — rare and cheap vs hanging the pull, and the
                # admission permit, forever).
                for src in {v[2] for v in inflight.values()}:
                    addr = self.node_addrs.get(src)
                    if addr is not None:
                        self._peers.invalidate(addr)
                continue
            for fut in done:
                off, ln, src, attempts = inflight.pop(fut)
                exc = fut.exception()
                data = None if exc is not None else fut.result()
                if exc is not None or data is None or len(data) != ln:
                    if len(sources) > 1 and src in sources:
                        sources.remove(src)  # failover to other holders
                    elif attempts >= cfg.rpc_retry_max_attempts:
                        raise ObjectLostError(
                            object_id.hex(),
                            f"chunk @{off} failed from {src}: "
                            f"{exc or 'gone'}")
                    else:
                        time.sleep(cfg.object_pull_retry_ms / 1000.0)
                    issue(off, attempts + 1)
                    continue
                dest[off:off + ln] = data
                if self._acct:
                    self._m_pull_in_bytes.inc(ln)
                if next_i < len(offsets):
                    issue(offsets[next_i])
                    next_i += 1

    def _notify_pulled(self, ref: ObjectRef) -> None:
        """Report our freshly-cached copy to the owner's directory so
        later pulls can stripe across us too."""
        if ref.owner_id() == self.worker.worker_id:
            with self._lock:
                self.secondary.setdefault(ref.id(), set()).add(
                    self.local_node_id)
            return
        try:
            self.owner_client(ref.owner_id()).oneway(
                "add_location", {"object_id": ref.id().binary(),
                                 "node_id": self.local_node_id})
        except Exception:  # noqa: BLE001 — advisory only
            pass

    def get_from_store(self, ref: ObjectRef) -> Tuple[Any, bool]:
        """Blocking read of a sealed object; pulls cross-node if needed.

        The zero-copy view stays pinned until the object is freed locally
        (reference: plasma client pin semantics).
        """
        oid = ref.id()
        if not self.store.contains(oid.binary()):
            node_id = self.locations.get(oid)
            if node_id is None:
                reply = self.owner_client(ref.owner_id()).call(
                    "get_object",
                    {"object_id": oid.binary(),
                     "requester": self.worker.worker_id.binary()})
                if not reply or "shm" not in reply:
                    raise ObjectLostError(oid.hex(), "no longer in shm")
                node_id = reply["shm"]
                sources = reply.get("shm_all")
            else:
                with self._lock:
                    sources = list(self.secondary.get(oid, ()))
            oneshot = self._pull_to_local(oid, node_id, sources=sources,
                                          owner=ref.owner_id().hex())
            if oneshot is not None:
                return serialization.deserialize(oneshot), False
            self._notify_pulled(ref)
        # guard=True: each read holds its own pin, released when the last
        # zero-copy view derived from this get dies — NOT when the
        # ObjectRef dies. Freeing the ref must never let the arena reuse
        # memory still aliased by live numpy views (the corruption class
        # this replaced: free → LRU reuse → a later block's bytes showing
        # through an earlier block's array).
        view = self.store.get(oid.binary(), guard=True)
        if view is None:
            spilled = self._read_spill(oid)
            if spilled is not None:
                return serialization.deserialize(spilled), False
            raise ObjectLostError(oid.hex(), "evicted from shm")
        value = serialization.deserialize(view)
        return value, False

    # -------------------------------------------------- owner service handlers

    def handle_get_object(self, p, ctx):
        oid = ObjectID(p["object_id"])
        entry = self.worker.memory_store.get_if_ready(oid)
        if entry is None:
            # No value yet: either the producing task is still running
            # (refcount still tracks the oid) or we already freed it —
            # answer None so the borrower surfaces ObjectLostError instead
            # of polling forever.
            if not self.worker.refcounter.is_tracked(oid):
                return None
            return {"pending": True}
        value, is_error, in_shm = entry
        if in_shm:
            primary = self.locations.get(oid, self.local_node_id)
            with self._lock:
                alts = [n for n in self.secondary.get(oid, ())
                        if n != primary]
            return {"shm": primary, "shm_all": [primary] + alts}
        so = (serialization.serialize_error(value) if is_error
              else serialization.serialize(value))
        data = so.to_bytes()
        requester = p.get("requester")
        for r in so.contained_refs:
            # transfer-before-release: pre-register the requester as a
            # borrower of refs we own so releasing our serialize-time pin
            # can't race its registration (see worker_main._reply_ok)
            if requester and r.owner_id() == self.worker.worker_id:
                self.worker.refcounter.add_borrower(r.id(), requester)
            self.worker.refcounter.on_serialized_ref_done(r.id())
        return {"inline": data, "is_error": is_error}

    def handle_add_location(self, p, ctx):
        with self._lock:
            self.secondary.setdefault(
                ObjectID(p["object_id"]), set()).add(p["node_id"])
        return True

    def handle_add_borrower(self, p, ctx):
        self.worker.refcounter.add_borrower(
            ObjectID(p["object_id"]), p["borrower"])
        return True

    def handle_remove_borrower(self, p, ctx):
        self.worker.refcounter.remove_borrower(
            ObjectID(p["object_id"]), p["borrower"])
        return True

    # ------------------------------------------------------------------ free

    def free_object(self, object_id: ObjectID) -> None:
        """Owner decided the object is garbage (refcount hit zero).

        Read pins are guard-managed (see get_from_store) so there is
        nothing to release here; the holder node drops the primary copy
        (the store defers actual reclamation until reader pins drain —
        delete_pending in shm_store.cc)."""
        key = object_id.binary()
        node_id = self.locations.pop(object_id, None)
        with self._lock:
            secondaries = self.secondary.pop(object_id, set())
            self._dir.pop(object_id, None)
        secondaries.discard(node_id)
        # Oneway, and never a blocking call on THIS thread: this path runs
        # inside reply callbacks on the transport dispatcher, and
        # node_client's refresh path calls the head. Nodes already in the
        # cached map get their delete directly; nodes that joined after
        # our last refresh (autoscale) are handled by a background thread
        # that refreshes the map first — skipping them would leak their
        # pinned primary copies until the arena fills.
        targets = ([node_id] if node_id is not None else []) \
            + list(secondaries)
        retry = []  # unknown-addr nodes AND definite send failures: a
        # dropped delete leaks the pinned primary in the node's shm arena
        # until restart, so both get one background retry after a refresh.
        for n in targets:
            addr = self.node_addrs.get(n)
            if addr is None or not self._peers.get(addr).oneway(
                    "delete_object", {"object_id": key}):
                retry.append(n)
        if retry:
            self._queue_late_deletes(key, retry)
        with self._lock:
            contained = self._contained.pop(object_id, [])
        me = self.worker.worker_id.binary()
        for r in contained:
            if r.owner_id() == self.worker.worker_id:
                self.worker.refcounter.remove_borrower(r.id(), me)
                continue
            try:
                self.owner_client(r.owner_id()).call(
                    "remove_borrower",
                    {"object_id": r.id().binary(), "borrower": me})
            except (RpcError, ObjectLostError):
                pass

    #: attempts per late delete — a node mid-restart needs a couple of
    #: rounds; a node that never answers is presumed gone (its arena
    #: dies with it, so nothing leaks by giving up)
    _LATE_DELETE_TRIES = 3

    def _queue_late_deletes(self, key: bytes, nodes: list) -> None:
        with self._lock:
            self._late_deletes.extend((n, key, 0) for n in nodes)
            if self._late_thread_live:
                return
            self._late_thread_live = True
        threading.Thread(target=self._drain_late_deletes, daemon=True,
                         name="late-delete").start()

    def _drain_late_deletes(self) -> None:
        try:
            while True:
                time.sleep(0.2)  # coalesce a burst into one refresh
                with self._lock:
                    batch, self._late_deletes = self._late_deletes, []
                    if not batch:
                        self._late_thread_live = False
                        return
                self.refresh_nodes()  # swallows head errors; stale
                # addrs then fail the send below and re-queue
                requeue = []
                for n, key, tries in batch:
                    addr = self.node_addrs.get(n)
                    if addr is None:
                        continue  # node left the cluster: arena is gone
                    if not self._peers.get(addr).oneway(
                            "delete_object", {"object_id": key}) \
                            and tries + 1 < self._LATE_DELETE_TRIES:
                        requeue.append((n, key, tries + 1))
                if requeue:
                    with self._lock:
                        self._late_deletes.extend(requeue)
        except Exception:  # noqa: BLE001 — best-effort cleanup
            with self._lock:
                self._late_thread_live = False

    def release_local_pin(self, object_id: ObjectID) -> None:
        """Borrow-release hook. Read pins are tied to view lifetime by the
        guard in get_from_store, so the unborrow path has nothing to
        release locally; kept as the seam where explicit local pinning
        would go (reference: plasma client Release)."""

    def shutdown(self) -> None:
        self._peers.close_all()
        self.store.close()
