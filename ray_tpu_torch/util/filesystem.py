"""StorageFilesystem: the one durable-state seam (ROADMAP item 7).

Train checkpoints, workflow storage, and object-plane spill all write
durable bytes; before this seam each rolled its own ``open()`` calls, so
none could be pointed at remote storage, fault-injected, or retried
uniformly. The seam is deliberately minimal — an fsspec-style put/get/
list/delete/rename over opaque paths — with three implementations:

* :class:`LocalFilesystem` — the default; byte-for-byte the old on-disk
  layout (atomic publish via tmp-file + ``os.replace``), so local runs
  are unchanged.
* :class:`MemoryFilesystem` — a dict behind a lock, for tests and for
  modelling remote object stores (no partial writes, no directories).
* :class:`FaultInjectableFilesystem` — wraps any backend with the
  ``fault_injector`` points ``storage.put`` / ``storage.get`` /
  ``storage.delete`` (chaos tests SIGKILL a host mid-shard-write through
  these) plus a bounded full-jitter retry/backoff policy for transient
  errors (reference pattern: GCS client retries; TorchTitan's async
  checkpoint uploads survive blips the same way).

``storage_filesystem()`` is the resolver the three subsystems share:
``None``/path → local (fault-injectable), ``"memory://name"`` → a
process-wide named in-memory store, an instance → itself.

Jax-free by construction: the object-plane daemon and workflow drivers
import this without pulling in the accelerator stack.
"""

from __future__ import annotations

import os
import random
import shutil
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch.util import fault_injector

# -- typed errors ------------------------------------------------------------


class StorageError(Exception):
    """Base class for storage-seam failures."""


class TransientStorageError(StorageError):
    """A retryable failure (network blip, throttle). The retry wrapper
    swallows up to ``RetryPolicy.max_attempts - 1`` of these."""


# -- retry policy ------------------------------------------------------------


class RetryPolicy:
    """Bounded full-jitter exponential backoff (AWS-style): sleep is
    uniform in [0, min(cap, base * 2**attempt)] so a fleet of hosts
    retrying one flaky store never thunders in lockstep."""

    __slots__ = ("max_attempts", "base_s", "cap_s")

    def __init__(self, max_attempts: int = 4, base_s: float = 0.05,
                 cap_s: float = 2.0):
        self.max_attempts = max(1, int(max_attempts))
        self.base_s = base_s
        self.cap_s = cap_s

    def backoff_s(self, attempt: int) -> float:
        """Full-jitter sleep before retry number ``attempt`` (1-based)."""
        return random.uniform(
            0.0, min(self.cap_s, self.base_s * (2.0 ** attempt)))


#: Errors the retry wrapper treats as transient. ``FaultInjected`` is
#: included so a ``storage.put=raise*2`` spec models "fail twice then
#: succeed" without any test bookkeeping. FileNotFoundError is NOT
#: transient — a missing object never appears by waiting.
_TRANSIENT = (TransientStorageError, fault_injector.FaultInjected, OSError)


# -- the seam ----------------------------------------------------------------


class StorageFilesystem:
    """Minimal durable-bytes interface. Paths are opaque '/'-separated
    strings; ``put`` must publish atomically (readers see the whole value
    or nothing — the checkpoint commit protocol leans on this)."""

    def put(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, path: str) -> bytes:
        """Read the whole object; raises FileNotFoundError when absent."""
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        try:
            self.get(path)
            return True
        except FileNotFoundError:
            return False

    def list(self, prefix: str) -> List[str]:
        """Immediate child names under ``prefix`` (files and 'dirs'),
        sorted; empty when the prefix doesn't exist."""
        raise NotImplementedError

    def delete(self, path: str) -> None:
        """Remove a file or a whole subtree; absent paths are a no-op."""
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> None:
        """Atomic move (same-store); raises FileNotFoundError on missing
        src."""
        raise NotImplementedError


class LocalFilesystem(StorageFilesystem):
    """POSIX-backed default. ``put`` stages to ``<path>.tmp.<pid>`` and
    ``os.replace``s into place — the same atomic-publish idiom every
    subsystem used before the seam, now in one place."""

    def __init__(self, root: str = ""):
        self.root = root

    def _abs(self, path: str) -> str:
        return os.path.join(self.root, path) if self.root else path

    def put(self, path: str, data: bytes) -> None:
        p = self._abs(path)
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        tmp = f"{p}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, p)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def get(self, path: str) -> bytes:
        with open(self._abs(path), "rb") as f:
            return f.read()

    def exists(self, path: str) -> bool:
        return os.path.exists(self._abs(path))

    def list(self, prefix: str) -> List[str]:
        try:
            return sorted(os.listdir(self._abs(prefix)))
        except (FileNotFoundError, NotADirectoryError):
            return []

    def delete(self, path: str) -> None:
        p = self._abs(path)
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
        else:
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass

    def rename(self, src: str, dst: str) -> None:
        d = self._abs(dst)
        os.makedirs(os.path.dirname(d) or ".", exist_ok=True)
        os.replace(self._abs(src), d)


class MemoryFilesystem(StorageFilesystem):
    """Dict-backed store for tests: inherently atomic puts, trivially
    inspectable, and shareable process-wide via ``memory://<name>``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._objects: Dict[str, bytes] = {}

    @staticmethod
    def _norm(path: str) -> str:
        return path.strip("/")

    def put(self, path: str, data: bytes) -> None:
        with self._lock:
            self._objects[self._norm(path)] = bytes(data)

    def get(self, path: str) -> bytes:
        with self._lock:
            try:
                return self._objects[self._norm(path)]
            except KeyError:
                raise FileNotFoundError(path) from None

    def exists(self, path: str) -> bool:
        p = self._norm(path)
        with self._lock:
            return p in self._objects or any(
                k.startswith(p + "/") for k in self._objects)

    def list(self, prefix: str) -> List[str]:
        p = self._norm(prefix)
        head = f"{p}/" if p else ""
        out = set()
        with self._lock:
            for k in self._objects:
                if k.startswith(head):
                    out.add(k[len(head):].split("/", 1)[0])
        return sorted(out)

    def delete(self, path: str) -> None:
        p = self._norm(path)
        with self._lock:
            self._objects.pop(p, None)
            for k in [k for k in self._objects if k.startswith(p + "/")]:
                del self._objects[k]

    def rename(self, src: str, dst: str) -> None:
        s, d = self._norm(src), self._norm(dst)
        with self._lock:
            if s in self._objects:
                self._objects[d] = self._objects.pop(s)
                return
            moved = False
            for k in [k for k in self._objects if k.startswith(s + "/")]:
                self._objects[d + k[len(s):]] = self._objects.pop(k)
                moved = True
            if not moved:
                raise FileNotFoundError(src)


class FaultInjectableFilesystem(StorageFilesystem):
    """Chaos + resilience wrapper around any backend.

    Every op first fires its ``storage.<op>`` fault point (list/rename/
    exists ride the read/write points of the op they resemble), then runs
    with bounded full-jitter retries on transient errors. Retries are
    observable: each one bumps ``storage_retry_total{op}`` and the final
    outcome's latency lands in ``storage_op_seconds{op}``.
    """

    def __init__(self, inner: StorageFilesystem,
                 retry: Optional[RetryPolicy] = None):
        self.inner = inner
        self.retry = retry or RetryPolicy()
        from ray_tpu_torch.util import metrics as metrics_mod
        self._m_retry = metrics_mod.storage_retry_total_counter()
        self._m_seconds = metrics_mod.storage_op_seconds_histogram()
        self._m_put_bytes = metrics_mod.storage_put_bytes_counter()

    def _run(self, op: str, point: str, fn, *args):
        t0 = time.monotonic()
        attempt = 0
        while True:
            try:
                fault_injector.fire(point)
                out = fn(*args)
                self._m_seconds.observe(time.monotonic() - t0,
                                        tags={"op": op})
                return out
            except FileNotFoundError:
                raise  # absence is an answer, not a fault
            except _TRANSIENT as e:
                attempt += 1
                if attempt >= self.retry.max_attempts:
                    self._m_seconds.observe(time.monotonic() - t0,
                                            tags={"op": op})
                    raise StorageError(
                        f"storage {op} failed after {attempt} "
                        f"attempts: {e!r}") from e
                self._m_retry.inc(tags={"op": op})
                time.sleep(self.retry.backoff_s(attempt))

    def put(self, path: str, data: bytes) -> None:
        self._run("put", "storage.put", self.inner.put, path, data)
        self._m_put_bytes.inc(len(data))

    def get(self, path: str) -> bytes:
        return self._run("get", "storage.get", self.inner.get, path)

    def exists(self, path: str) -> bool:
        return self._run("exists", "storage.get", self.inner.exists, path)

    def list(self, prefix: str) -> List[str]:
        return self._run("list", "storage.get", self.inner.list, prefix)

    def delete(self, path: str) -> None:
        self._run("delete", "storage.delete", self.inner.delete, path)

    def rename(self, src: str, dst: str) -> None:
        self._run("rename", "storage.put", self.inner.rename, src, dst)


# -- resolver ----------------------------------------------------------------

_memory_stores: Dict[str, MemoryFilesystem] = {}
_memory_lock = threading.Lock()


def storage_filesystem(spec=None) -> StorageFilesystem:
    """Resolve a storage spec to a filesystem.

    ``None`` or a path string → fault-injectable local filesystem (the
    path string is NOT used as a root — callers keep passing absolute
    paths, preserving every existing on-disk layout). ``"memory://x"`` →
    the process-wide named MemoryFilesystem (created on first use).
    A StorageFilesystem instance passes through unwrapped.
    """
    if isinstance(spec, StorageFilesystem):
        return spec
    if isinstance(spec, str) and spec.startswith("memory://"):
        name = spec[len("memory://"):] or "default"
        with _memory_lock:
            if name not in _memory_stores:
                _memory_stores[name] = MemoryFilesystem()
            return FaultInjectableFilesystem(_memory_stores[name])
    return FaultInjectableFilesystem(LocalFilesystem())
