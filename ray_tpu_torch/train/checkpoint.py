"""Async, sharded, crash-consistent checkpoints over the storage seam —
the PyTorch port of ``ray_tpu/train/checkpoint.py``, in its file format:
a checkpoint written by either package restores in the other, on any
number of ranks.

Reference equivalents: python/ray/train/_checkpoint.py (Checkpoint as a
directory handle) + train/_internal/storage.py (StorageContext), rebuilt
around the TorchTitan async-distributed-checkpoint pattern (arXiv:
2410.06511 — saves overlap compute so step time stays flat) and the
veScale per-host-shard layout (arXiv:2509.07003 — state re-shards onto a
resized mesh at restore).

Commit protocol (crash consistency without locks):

1. Every rank serializes ONLY its own pieces — the local shard of each
   DTensor, when the rank holds the replica-0 copy of it (coordinate 0 on
   every mesh axis the tensor is replicated over), with its global shape
   and bounds — into ``shard-<rank>.npz`` (no rank ever materializes the
   full tree). Plain tensors, numpy arrays and scalars are rank 0's.
2. Each shard upload is an atomic ``put`` through the
   :mod:`ray_tpu_torch.util.filesystem` seam, followed by a tiny
   ``shard-<host>.ok.json`` sidecar carrying size + sha256.
3. Host 0 waits for every sidecar to become visible (a storage-level
   barrier — a dead host simply never produces one), then writes
   ``MANIFEST.json`` LAST. The manifest IS the commit marker: a
   directory without one is invisible to ``CheckpointManager.latest()``
   and gets garbage-collected (+ ``checkpoint_abandoned`` journal
   record) at the next manager init.
4. ``load()`` re-verifies every shard digest against the manifest and
   raises :class:`CheckpointCorrupt` on mismatch, falling back to the
   next-newest committed checkpoint when the manager handed one out.

The async writer is double-buffered with a bounded queue (depth 1): the
only work on the training thread is the device→host copy; serialization,
upload, barrier, and commit run on a background thread. Errors surface
on the next ``save``/``save_async`` and at ``flush()``.

Chaos points (``ray_tpu_torch.util.fault_injector``): ``checkpoint.
shard_write`` and ``checkpoint.manifest_write`` fire just before the
respective uploads, and every storage op fires ``storage.put/get/
delete`` inside the seam — SIGKILL there and the protocol above must
leave only committed state visible.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.util import fault_injector
from ray_tpu_torch.util import metrics as metrics_mod
from ray_tpu_torch.util import trace_context
from ray_tpu_torch.util.filesystem import (StorageFilesystem, LocalFilesystem,
                                     FaultInjectableFilesystem,
                                     storage_filesystem)

logger = logging.getLogger(__name__)

MANIFEST_FILE = "MANIFEST.json"
_METRICS_FILE = "metrics.json"
# legacy (pre-manifest) single-file layout, still readable:
_TREE_FILE = "tree.json"
_ARRAYS_FILE = "arrays.npz"


class CheckpointCorrupt(RuntimeError):
    """A committed checkpoint failed digest/content verification."""


class CheckpointAbandoned(RuntimeError):
    """A save could not commit (a host never produced its shard)."""


def _esc(key: str) -> str:
    """Escape the path separators; keys like haiku's 'mlp/~/linear_0' survive."""
    return key.replace("%", "%25").replace("/", "%2F").replace(":", "%3A")


def _unesc(key: str) -> str:
    return key.replace("%3A", ":").replace("%2F", "/").replace("%25", "%")


def _flatten(tree, prefix=""):
    """Flatten nested dict/list/tuple pytrees into {path: leaf}.

    Dict keys keep their type: int keys get a 'di:' token (str keys 'd:')
    so restore rebuilds real int keys — otherwise a dict with keys >= 10
    would restore in lexicographic order ('10' < '2') and load(target=...)
    would zip leaves against the target's numeric order, silently assigning
    arrays to the wrong leaves.
    """
    out = {}
    if isinstance(tree, dict) and tree:
        for k in sorted(tree, key=lambda k: (isinstance(k, str), k)):
            tag = "di" if type(k) is int else "d"
            out.update(_flatten(tree[k], f"{prefix}{tag}:{_esc(str(k))}/"))
    elif isinstance(tree, (list, tuple)) and tree:
        tag = "l" if isinstance(tree, list) else "t"
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{tag}:{i}/"))
    elif isinstance(tree, (dict, list, tuple)):  # empty container leaf
        kind = "d" if isinstance(tree, dict) else (
            "l" if isinstance(tree, list) else "t")
        out[f"{prefix}{kind}:<empty>"] = None
    else:
        out[prefix.rstrip("/")] = tree
    return out


class _Node(dict):
    pass


def _unflatten(flat: Dict[str, Any]):
    """Inverse of _flatten: paths are '/'-joined 'kind:key' tokens."""
    if "" in flat:  # bare top-level leaf
        return flat[""]
    root = _Node()
    for path, leaf in flat.items():
        parts = path.split("/")
        node = root
        for tok in parts[:-1]:
            node = node.setdefault(tok, _Node())
        node[parts[-1]] = leaf

    def convert(node):
        if not isinstance(node, _Node):
            return node
        kinds = {tok.split(":", 1)[0] for tok in node}
        if len(kinds) != 1 and kinds != {"d", "di"}:  # str+int keys may mix
            raise ValueError(f"mixed container kinds at one node: {kinds}")
        kind = kinds.pop() if len(kinds) == 1 else "d"
        if set(node) == {f"{kind}:<empty>"}:
            return {"d": {}, "l": [], "t": ()}[kind]
        items = {}
        for tok, v in node.items():
            tag, key = tok.split(":", 1)
            items[int(key) if tag == "di" else _unesc(key)] = convert(v)
        if kind in ("d", "di"):
            return items
        seq = [items[str(i)] for i in range(len(items))]
        return seq if kind == "l" else tuple(seq)

    return convert(root)


def _is_dtensor(x) -> bool:
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # pragma: no cover - torch without distributed
        return False
    return isinstance(x, DTensor)


def _to_numpy(t) -> np.ndarray:
    """A host copy of a tensor: bf16 widens to float32, which holds every
    bf16 value exactly (numpy has no bf16 of its own)."""
    import torch
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def gather_to_host(tree):
    """Materialize a (possibly sharded) tree on THIS rank: each DTensor
    all-gathered (every rank must call this together).

    Retained for callers that genuinely need the full tree locally; the
    checkpoint save path does not use it — each rank persists only its
    own pieces.
    """
    def leaf(x):
        return x.full_tensor() if _is_dtensor(x) else x

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return leaf(t)

    return walk(tree)


def shard_bounds(global_shape, mesh, placements) -> List[List[int]]:
    """[[start, stop], ...] per dim of this rank's shard of a tensor of
    ``global_shape`` laid out by ``placements`` on ``mesh`` (the mesh
    axes sharding one dim split it in mesh order, the first major; the
    shards are equal)."""
    coord = mesh.get_coordinate()
    bounds = []
    for d, n in enumerate(global_shape):
        index, parts = 0, 1
        for i, pl in enumerate(placements):
            if pl.is_shard(d):
                index = index * mesh.size(i) + coord[i]
                parts *= mesh.size(i)
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(global_shape)} does not "
                             f"split into {parts} equal shards")
        step = n // parts
        bounds.append([index * step, (index + 1) * step])
    return bounds


def _owns_replica0(mesh, placements) -> bool:
    coord = mesh.get_coordinate()
    return all(coord[i] == 0 for i, pl in enumerate(placements)
               if pl.is_replicate())


# ---------------------------------------------------------------------------
# shard extraction / (de)serialization


def _index_bounds(index: Tuple, shape: Tuple[int, ...]) -> List[List[int]]:
    """Normalize a Shard.index (tuple of slices) to [[start, stop], ...]."""
    out = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        out.append([start, stop])
    return out


def shard_name(host: int) -> str:
    return f"shard-{host:05d}.npz"


def _sidecar_name(host: int) -> str:
    return f"shard-{host:05d}.ok.json"


def extract_host_pieces(tree, rank: int = 0):
    """Device->host copy of THIS rank's pieces.

    This is the only step that runs on the training thread. Returns
    (pieces, scalars): pieces is {aid: {key, gshape, index, data}} where
    ``index`` is None for whole arrays (rank 0 owns those) and a
    [[start, stop], ...] bound list for a DTensor's local shard (the rank
    holding its replica-0 copy owns it); scalars are rank 0's JSON-able
    leaves.
    """
    import torch
    flat = _flatten(tree)
    pieces: Dict[str, dict] = {}
    scalars: Dict[str, Any] = {}
    i = 0
    for key, v in flat.items():
        if _is_dtensor(v):
            if not _owns_replica0(v.device_mesh, v.placements):
                continue  # exactly one rank owns each piece
            pieces[f"a{i}"] = {
                "key": key, "gshape": list(v.shape),
                "index": shard_bounds(v.shape, v.device_mesh, v.placements),
                "data": _to_numpy(v.to_local())}
            i += 1
        elif getattr(v, "shard_info", None) is not None:
            raise ValueError(f"{key}: a rank's local shard "
                             f"(train_step.local_shard) holds one piece "
                             f"of its leaf; save the DTensor")
        elif isinstance(v, (np.ndarray, np.generic, torch.Tensor)):
            if rank == 0:
                arr = _to_numpy(v) if isinstance(v, torch.Tensor) \
                    else np.asarray(v)
                pieces[f"a{i}"] = {"key": key, "gshape": list(arr.shape),
                                   "index": None, "data": arr}
                i += 1
        elif rank == 0:
            scalars[key] = v
    return pieces, scalars


def _serialize_shard(pieces: Dict[str, dict], scalars: Dict[str, Any],
                     host: int, world: int, step: int) -> bytes:
    meta = {"host": host, "world": world, "step": step,
            "time": time.time(),
            "pieces": {aid: {"key": p["key"], "gshape": p["gshape"],
                             "index": p["index"]}
                       for aid, p in pieces.items()},
            "scalars": scalars}
    buf = io.BytesIO()
    np.savez(buf,
             __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             **{aid: p["data"] for aid, p in pieces.items()})
    return buf.getvalue()


def _absorb_shard(data: bytes, flat: Dict[str, Any],
                  scalars: Dict[str, Any]) -> None:
    """Merge one shard file's pieces into the assembling flat tree."""
    z = np.load(io.BytesIO(data))
    meta = json.loads(z["__meta__"].tobytes().decode())
    for aid, pm in meta["pieces"].items():
        arr = z[aid]
        if pm["index"] is None:
            flat[pm["key"]] = arr
        else:
            gshape = tuple(pm["gshape"])
            buf = flat.get(pm["key"])
            if not isinstance(buf, np.ndarray) or buf.shape != gshape:
                buf = np.empty(gshape, arr.dtype)
                flat[pm["key"]] = buf
            buf[tuple(slice(s, e) for s, e in pm["index"])] = arr
    scalars.update(meta.get("scalars", {}))


# ---------------------------------------------------------------------------
# best-effort cluster event journal hook (no-op outside a cluster)


def _journal(etype: str, trace_id: str = "", **fields) -> None:
    try:
        from ray_tpu_torch.core.worker import global_worker
        head = getattr(getattr(global_worker, "backend", None), "head", None)
        if head is None:
            return
        head.call("journal_record",
                  {"type": etype, "trace_id": trace_id, **fields},
                  timeout=5)
    except Exception:  # noqa: BLE001 — telemetry must never fail a save
        pass


# ---------------------------------------------------------------------------


def _restore_like(target, value, where="tree"):
    """``value`` (a loaded tree) in ``target``'s structure and leaf types."""
    import torch
    if isinstance(target, dict):
        if not isinstance(value, dict) or set(value) != set(target):
            have = sorted(map(str, value)) if isinstance(value, dict) \
                else type(value).__name__
            raise ValueError(f"{where}: checkpoint holds {have}, target "
                             f"keys {sorted(map(str, target))}")
        return {k: _restore_like(target[k], value[k], f"{where}/{k}")
                for k in target}
    if isinstance(target, (list, tuple)):
        if not isinstance(value, (list, tuple)) or len(value) != len(target):
            raise ValueError(f"{where}: checkpoint holds {value!r:.60}, "
                             f"target a sequence of {len(target)}")
        return type(target)(_restore_like(t, v, f"{where}/{i}")
                            for i, (t, v) in enumerate(zip(target, value)))
    if _is_dtensor(target):
        from torch.distributed.tensor import DTensor
        mesh, pl = target.device_mesh, target.placements
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{where}: checkpoint shape {value.shape}, "
                             f"target {tuple(target.shape)}")
        piece = value[tuple(slice(a, b) for a, b in
                            shard_bounds(target.shape, mesh, pl))]
        local = torch.from_numpy(np.ascontiguousarray(piece)).to(
            device=target.to_local().device, dtype=target.dtype)
        return DTensor.from_local(local, mesh, pl, run_check=False)
    if isinstance(target, torch.Tensor):
        return torch.from_numpy(np.array(value, copy=True)).to(
            device=target.device, dtype=target.dtype)
    return value


class Checkpoint:
    """Handle to a checkpoint directory (reference: Checkpoint.from_directory).

    ``fallbacks`` (manager-provided) are older COMMITTED checkpoint dirs
    tried in order when this one fails verification.
    """

    def __init__(self, path: str, fs: Optional[StorageFilesystem] = None,
                 fallbacks: Tuple[str, ...] = ()):
        self.path = path
        self.fs = storage_filesystem(fs)
        self.fallbacks = tuple(fallbacks)
        #: the directory actually loaded (set by load(); differs from
        #: ``path`` when digest verification forced a fallback)
        self.resolved_path = path

    @staticmethod
    def from_directory(path: str) -> "Checkpoint":
        return Checkpoint(path)

    @staticmethod
    def save(tree, path: str, metrics: Optional[dict] = None,
             fs: Optional[StorageFilesystem] = None) -> "Checkpoint":
        """Synchronous single-host write of `tree` into `path` (world=1
        commit protocol: shard, sidecar, then manifest)."""
        f = storage_filesystem(fs)
        pieces, scalars = extract_host_pieces(tree, rank=0)
        _write_and_commit(f, path, step=CheckpointManager.step_of(path),
                          pieces=pieces, scalars=scalars, host=0, world=1,
                          metrics=metrics,
                          trace_id=trace_context.new_trace_id())
        return Checkpoint(path, fs=f)

    # -- read side ----------------------------------------------------------

    def _manifest(self) -> Optional[dict]:
        try:
            return json.loads(
                self.fs.get(os.path.join(self.path, MANIFEST_FILE)))
        except FileNotFoundError:
            return None

    def load(self, target=None):
        """Restore the tree, verifying every shard digest: arrays as numpy
        arrays, the scalars as saved.

        target: optional template tree. The result takes its structure,
            and each tensor leaf of it its type: a DTensor leaf comes back
            as a DTensor on the template's mesh and placements (this
            rank's slice of the saved array: how a restore re-shards onto
            a new mesh), a tensor as a tensor of the template's dtype and
            device.

        Raises :class:`CheckpointCorrupt` when a shard is missing or its
        digest mismatches; when the manager supplied fallbacks, older
        committed checkpoints are tried (newest first) before raising.
        """
        try:
            flat = self._load_flat()
        except CheckpointCorrupt as e:
            if not self.fallbacks:
                raise
            logger.warning("checkpoint %s corrupt (%s); falling back to %s",
                           self.path, e, self.fallbacks[0])
            fb = Checkpoint(self.fallbacks[0], fs=self.fs,
                            fallbacks=self.fallbacks[1:])
            out = fb.load(target=target)
            self.resolved_path = fb.resolved_path
            return out
        self.resolved_path = self.path
        tree = _unflatten(flat)
        return tree if target is None else _restore_like(target, tree)

    def _load_flat(self) -> Dict[str, Any]:
        manifest = self._manifest()
        if manifest is None:
            return self._load_legacy_flat()
        flat: Dict[str, Any] = {}
        scalars: Dict[str, Any] = {}
        for entry in manifest["shards"]:
            p = os.path.join(self.path, entry["name"])
            try:
                data = self.fs.get(p)
            except FileNotFoundError:
                raise CheckpointCorrupt(
                    f"{self.path}: shard {entry['name']} missing") from None
            digest = hashlib.sha256(data).hexdigest()
            if digest != entry["sha256"]:
                raise CheckpointCorrupt(
                    f"{self.path}: shard {entry['name']} digest mismatch "
                    f"({digest[:12]} != {entry['sha256'][:12]})")
            _absorb_shard(data, flat, scalars)
        flat.update(scalars)
        return flat

    def _load_legacy_flat(self) -> Dict[str, Any]:
        """Pre-manifest layout: one tree.json + arrays.npz."""
        try:
            meta = json.loads(
                self.fs.get(os.path.join(self.path, _TREE_FILE)))
            data = np.load(io.BytesIO(
                self.fs.get(os.path.join(self.path, _ARRAYS_FILE))))
        except FileNotFoundError:
            raise FileNotFoundError(
                f"no checkpoint at {self.path} (no manifest, no legacy "
                f"tree)") from None
        flat = dict(meta["scalars"])
        for aid, key in meta["keys"].items():
            flat[key] = data[aid]
        return flat

    def metrics(self) -> dict:
        try:
            return json.loads(
                self.fs.get(os.path.join(self.path, _METRICS_FILE)))
        except FileNotFoundError:
            return {}


# ---------------------------------------------------------------------------
# write path shared by sync saves and the async writer thread


def _write_and_commit(fs: StorageFilesystem, dirpath: str, step: int,
                      pieces: Dict[str, dict], scalars: Dict[str, Any],
                      host: int, world: int,
                      metrics: Optional[dict],
                      trace_id: str,
                      barrier_timeout_s: float = 60.0,
                      on_committed=None) -> None:
    """One host's half of the commit protocol. Hosts > 0 return after
    their sidecar upload; host 0 runs the manifest barrier + commit."""
    t0 = time.monotonic()
    # a re-save into an existing committed dir: drop the commit marker
    # FIRST so no reader can pair old manifest with new shards
    if host == 0 and fs.exists(os.path.join(dirpath, MANIFEST_FILE)):
        fs.delete(os.path.join(dirpath, MANIFEST_FILE))
    blob = _serialize_shard(pieces, scalars, host, world, step)
    fault_injector.fire("checkpoint.shard_write")
    fs.put(os.path.join(dirpath, shard_name(host)), blob)
    sidecar = {"name": shard_name(host), "bytes": len(blob),
               "sha256": hashlib.sha256(blob).hexdigest(), "host": host}
    fs.put(os.path.join(dirpath, _sidecar_name(host)),
           json.dumps(sidecar).encode())
    metrics_mod.train_checkpoint_write_bytes_counter().inc(len(blob))
    if host != 0:
        metrics_mod.train_checkpoint_write_seconds_histogram().observe(
            time.monotonic() - t0)
        return
    # ---- host 0: storage-visibility barrier, then the commit marker
    want = {_sidecar_name(h) for h in range(world)}
    deadline = time.monotonic() + barrier_timeout_s
    while not want <= set(fs.list(dirpath)):
        if time.monotonic() >= deadline:
            missing = sorted(want - set(fs.list(dirpath)))
            _journal("checkpoint_abandoned", trace_id=trace_id,
                     path=dirpath, step=step, reason="barrier_timeout",
                     missing=",".join(missing))
            raise CheckpointAbandoned(
                f"{dirpath}: shards never arrived: {missing}")
        time.sleep(0.05)
    shards = [json.loads(fs.get(os.path.join(dirpath, _sidecar_name(h))))
              for h in range(world)]
    if metrics is not None:
        fs.put(os.path.join(dirpath, _METRICS_FILE),
               json.dumps(metrics).encode())
    manifest = {"format": 2, "step": step, "world_size": world,
                "shards": shards, "time": time.time(),
                "trace_id": trace_id}
    fault_injector.fire("checkpoint.manifest_write")
    fs.put(os.path.join(dirpath, MANIFEST_FILE),
           json.dumps(manifest, indent=1).encode())
    dt = time.monotonic() - t0
    metrics_mod.train_checkpoint_write_seconds_histogram().observe(dt)
    _journal("checkpoint_committed", trace_id=trace_id, path=dirpath,
             step=step, bytes=sum(s["bytes"] for s in shards),
             write_seconds=round(dt, 4), world_size=world)
    if on_committed is not None:
        on_committed()


class CheckpointManager:
    """Rotating checkpoint dirs under a run's storage path, with an
    optional async double-buffered writer (reference:
    train/_internal/checkpoint_manager.py + TorchTitan async saves).

    rank/world_size describe this host's place in the save gang; every
    rank constructs a manager over the same root and calls ``save`` /
    ``save_async`` collectively (rank 0 commits). ``latest()`` only ever
    surfaces COMMITTED checkpoints, newest first, with older committed
    dirs attached as verification fallbacks.
    """

    def __init__(self, root: str, num_to_keep: Optional[int] = None,
                 fs: Optional[StorageFilesystem] = None,
                 rank: int = 0, world_size: int = 1,
                 async_save: bool = False,
                 barrier_timeout_s: float = 60.0):
        self.root = root
        self.num_to_keep = num_to_keep
        self.fs = storage_filesystem(fs)
        self.rank = rank
        self.world_size = max(1, int(world_size))
        self.async_save = async_save
        self.barrier_timeout_s = barrier_timeout_s
        inner = self.fs.inner if isinstance(
            self.fs, FaultInjectableFilesystem) else self.fs
        if isinstance(inner, LocalFilesystem):
            os.makedirs(root, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._inflight = 0
        self._lock = threading.Lock()
        self._m_depth = metrics_mod.train_checkpoint_queue_depth_count()
        if rank == 0:
            self._gc_debris()

    # -- paths / listing ----------------------------------------------------

    def dir_for(self, step: int) -> str:
        return os.path.join(self.root, f"checkpoint_{step:08d}")

    @staticmethod
    def step_of(path: str) -> int:
        """Parse the step number out of a checkpoint dir path."""
        name = os.path.basename(path.rstrip("/"))
        try:
            return int(name.rsplit("_", 1)[-1])
        except ValueError:
            return 0

    def _all(self) -> List[str]:
        return sorted(
            os.path.join(self.root, d) for d in self.fs.list(self.root)
            if d.startswith("checkpoint_"))

    def _committed(self) -> List[str]:
        return [d for d in self._all()
                if self.fs.exists(os.path.join(d, MANIFEST_FILE))]

    def latest(self) -> Optional[Checkpoint]:
        """Newest COMMITTED checkpoint (manifestless dirs — in-flight or
        crash debris — are never surfaced), with older committed dirs as
        digest-verification fallbacks."""
        cs = self._committed()
        if not cs:
            return None
        return Checkpoint(cs[-1], fs=self.fs,
                          fallbacks=tuple(reversed(cs[:-1])))

    # -- garbage collection / pruning ---------------------------------------

    def _gc_debris(self) -> None:
        """Collect crash debris at (re)start: legacy mkdtemp/aside dirs,
        seam staging files, and manifestless checkpoint dirs (a save that
        died mid-shard or mid-manifest). Runs on rank 0 only, before any
        new save — nothing here can race a live writer."""
        for name in self.fs.list(self.root):
            path = os.path.join(self.root, name)
            if name.startswith("tmp") or name.startswith(".removing.") \
                    or ".tmp." in name:
                self.fs.delete(path)
                continue
            if name.startswith("checkpoint_") and not self.fs.exists(
                    os.path.join(path, MANIFEST_FILE)):
                self.fs.delete(path)
                _journal("checkpoint_abandoned", path=path,
                         step=self.step_of(path),
                         reason="uncommitted_at_restart")
                logger.warning(
                    "GC'd uncommitted checkpoint debris %s", path)

    def _prune(self) -> None:
        """Keep the newest ``num_to_keep`` COMMITTED checkpoints. Runs
        only AFTER a new manifest lands, and only ever deletes committed
        dirs strictly older than the newest commit — an in-flight
        (manifestless) dir or the checkpoint a concurrent ``latest()``
        just returned is never touched before a newer commit exists."""
        if not self.num_to_keep:
            return
        for stale in self._committed()[:-self.num_to_keep]:
            self.fs.delete(stale)

    # -- save path ----------------------------------------------------------

    def save(self, tree, step: int,
             metrics: Optional[dict] = None) -> Checkpoint:
        """Blocking save: submit + flush. On rank 0 this returns only
        after the manifest is committed."""
        self.save_async(tree, step, metrics)
        self.flush()
        return Checkpoint(self.dir_for(step), fs=self.fs)

    def save_async(self, tree, step: int,
                   metrics: Optional[dict] = None) -> None:
        """Non-blocking save. The device→host copy happens here (the only
        training-thread work); serialization + upload + commit run on the
        writer thread. A previous failure surfaces here, and a save
        arriving while the bounded queue (depth 1) is full blocks until
        the slot frees (double-buffering, never unbounded memory)."""
        self._raise_pending()
        pieces, scalars = extract_host_pieces(tree, rank=self.rank)
        self._ensure_writer()
        with self._lock:
            self._inflight += 1
            self._m_depth.set(float(self._inflight))
        self._q.put((self.dir_for(step), step, pieces, scalars, metrics,
                     trace_context.new_trace_id()))

    def in_flight(self) -> bool:
        with self._lock:
            return self._inflight > 0

    def flush(self, raise_errors: bool = True) -> None:
        """Wait for queued saves to finish; surface any writer error."""
        self._q.join()
        if raise_errors:
            self._raise_pending()

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(
                f"async checkpoint save failed: {err!r}") from err

    def _ensure_writer(self) -> None:
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True, name="ckpt-writer")
            self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            dirpath, step, pieces, scalars, metrics, trace_id = self._q.get()
            try:
                _write_and_commit(
                    self.fs, dirpath, step, pieces, scalars,
                    host=self.rank, world=self.world_size, metrics=metrics,
                    trace_id=trace_id,
                    barrier_timeout_s=self.barrier_timeout_s,
                    on_committed=self._prune)
            except BaseException as e:  # noqa: BLE001 — surfaced at flush
                with self._lock:
                    self._error = e
                logger.warning("checkpoint save %s failed: %r", dirpath, e)
            finally:
                with self._lock:
                    self._inflight -= 1
                    self._m_depth.set(float(self._inflight))
                self._q.task_done()
