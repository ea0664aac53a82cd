"""multiprocessing.Pool drop-in over cluster tasks.

Role-equivalent to the reference's ray.util.multiprocessing
(reference: python/ray/util/multiprocessing/pool.py): the stdlib Pool
surface — apply/apply_async/map/map_async/starmap/imap/imap_unordered —
executed as remote tasks, so an existing `from multiprocessing import
Pool` program scales across the cluster by switching one import.

Divergence from the stdlib worth knowing: ``processes`` bounds in-flight
CONCURRENCY (chunks submitted at once), not a fixed process pool — the
cluster's worker pool does process lifecycle; an initializer, when
given, runs lazily inside each chunk task (idempotent per worker
process, keyed on the function's export id).

The port of ``ray_tpu/util/multiprocessing.py``: user functions ship by
value except those of this package, numpy and torch, which every worker
imports by reference.
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


class AsyncResult:
    """stdlib-shaped handle over one or more ObjectRefs."""

    def __init__(self, refs: List[Any], single: bool,
                 chunked: bool = False):
        self._refs = refs
        self._single = single
        self._chunked = chunked

    def get(self, timeout: Optional[float] = None) -> Any:
        out = ray_tpu_torch.get(self._refs, timeout=timeout)
        if self._chunked:
            out = [x for chunk in out for x in chunk]
        return out[0] if self._single else out

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                     timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                                timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")
        try:
            ray_tpu_torch.get(self._refs, timeout=0)
            return True
        except Exception:  # noqa: BLE001 — stdlib contract: bool, not raise
            return False


def _dumps_by_value(obj) -> bytes:
    """cloudpickle with the user functions' modules forced BY VALUE.

    Plain pickling serializes a module-level function by reference, and
    a worker whose sys.path lacks the driver's script directory (the
    normal case for `python my_script.py` drivers) cannot import it.
    The stdlib Pool has no such problem — child processes inherit the
    parent's module state — so the drop-in must not either."""
    import sys
    import cloudpickle
    modules = set()
    for f in _iter_callables(obj):
        mod = sys.modules.get(getattr(f, "__module__", None))
        if mod is not None and mod.__name__ not in (
                "builtins", "__main__") and                 not mod.__name__.startswith(("ray_tpu_torch", "numpy", "torch")):
            modules.add(mod)
    for m in modules:
        try:
            cloudpickle.register_pickle_by_value(m)
        except Exception:  # noqa: BLE001 — fall back to by-reference
            modules = modules - {m}
    try:
        return cloudpickle.dumps(obj)
    finally:
        for m in modules:
            try:
                cloudpickle.unregister_pickle_by_value(m)
            except Exception:  # noqa: BLE001
                pass


def _iter_callables(obj, _depth: int = 0):
    if _depth > 3:
        return
    if callable(obj):
        yield obj
        # a wrapper lambda's own module may be ours while the USER fn
        # hides in its closure — walk cells too
        for cell in getattr(obj, "__closure__", None) or ():
            try:
                yield from _iter_callables(cell.cell_contents, _depth + 1)
            except ValueError:  # empty cell
                pass
    elif isinstance(obj, (tuple, list, set)):
        for x in obj:
            yield from _iter_callables(x, _depth + 1)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _iter_callables(x, _depth + 1)


def _run_chunk(blob, star):
    import cloudpickle
    fn, initializer, initargs, pool_token, items = cloudpickle.loads(blob)
    if initializer is not None:
        # once per worker process per POOL: keyed by the pool's token
        # string (stable across pickling), not id() of the unpickled
        # object (fresh every chunk, and recyclable across pools)
        memo = _run_chunk.__dict__.setdefault("_init_done", set())
        if pool_token not in memo:
            initializer(*initargs)
            memo.add(pool_token)
    if star:
        return [fn(*args) for args in items]
    return [fn(x) for x in items]


class Pool:
    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = (), ray_remote_args: Optional[dict] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self._processes = processes or (os.cpu_count() or 4)
        self._init = (initializer, tuple(initargs))
        self._remote_args = dict(ray_remote_args or {})
        self._task = ray_tpu_torch.remote(**self._remote_args)(_run_chunk) \
            if self._remote_args else ray_tpu_torch.remote(_run_chunk)
        self._token = os.urandom(8).hex()   # initializer-dedup key
        self._outstanding: List[Any] = []   # refs join() must wait on
        self._closed = False

    # ------------------------------------------------------------- helpers

    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            # stdlib heuristic: ~4 chunks per "process"
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)], chunksize

    def _chunk_blob(self, fn, chunk) -> bytes:
        """One by-value blob per chunk: fn, initializer AND the chunk's
        items all ship by value — callable ARGUMENTS from the driver's
        script module would otherwise pickle by reference and fail to
        import on workers (the exact failure the drop-in must prevent)."""
        initializer, initargs = self._init
        return _dumps_by_value(
            (fn, initializer, initargs, self._token, chunk))

    def _submit_one(self, fn, chunk, star):
        ref = self._task.remote(self._chunk_blob(fn, chunk), star)
        self._outstanding.append(ref)
        if len(self._outstanding) > 4096:   # prune completed, keep join()
            done, pending = ray_tpu_torch.wait(    # cheap on long-lived pools
                self._outstanding, num_returns=1, timeout=0)
            self._outstanding = pending
        return ref

    def _submit_chunks(self, fn, chunks, star) -> List[Any]:
        if self._closed:
            raise ValueError("Pool not running")
        refs = []
        inflight: List[Any] = []
        for chunk in chunks:
            # bound in-flight submissions so a huge map doesn't flood the
            # scheduler (the "processes" knob's meaning here)
            if len(inflight) >= self._processes:
                _, inflight = ray_tpu_torch.wait(inflight, num_returns=1,
                                           timeout=None)
            ref = self._submit_one(fn, chunk, star)
            refs.append(ref)
            inflight.append(ref)
        return refs

    # -------------------------------------------------------------- stdlib

    def apply(self, fn: Callable, args: tuple = (), kwds: dict = None) -> Any:
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwds: dict = None) -> AsyncResult:
        kwds = kwds or {}
        call = (lambda a: fn(*a, **kwds)) if kwds else (lambda a: fn(*a))
        refs = self._submit_chunks(call, [[args]], star=False)
        return AsyncResult(refs, single=True, chunked=True)

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None) -> AsyncResult:
        chunks, _ = self._chunks(iterable, chunksize)
        refs = self._submit_chunks(fn, chunks, star=False)
        return AsyncResult(refs, single=False, chunked=True)

    def starmap(self, fn: Callable, iterable: Iterable,
                chunksize: Optional[int] = None) -> List[Any]:
        chunks, _ = self._chunks(iterable, chunksize)
        refs = self._submit_chunks(fn, chunks, star=True)
        return AsyncResult(refs, single=False, chunked=True).get()

    def _lazy_chunks(self, iterable: Iterable, chunksize: Optional[int]):
        """Chunk a possibly-infinite iterable lazily (stdlib imap
        defaults to chunksize=1 and streams; list() here would hang on
        itertools.count())."""
        chunksize = chunksize or 1
        it = iter(iterable)
        while True:
            chunk = list(itertools.islice(it, chunksize))
            if not chunk:
                return
            yield chunk

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: Optional[int] = None):
        """Ordered lazy iterator: at most ``processes`` chunks in
        flight; input is consumed as results are yielded."""
        if self._closed:
            raise ValueError("Pool not running")
        import collections
        window: collections.deque = collections.deque()
        chunks = self._lazy_chunks(iterable, chunksize)
        for chunk in itertools.islice(chunks, self._processes):
            window.append(self._submit_one(fn, chunk, False))
        while window:
            ref = window.popleft()
            out = ray_tpu_torch.get(ref)
            nxt = next(chunks, None)
            if nxt is not None:
                window.append(self._submit_one(fn, nxt, False))
            yield from out

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: Optional[int] = None):
        """Results in completion order, not input order; same bounded
        streaming window as imap."""
        if self._closed:
            raise ValueError("Pool not running")
        chunks = self._lazy_chunks(iterable, chunksize)
        pending = [self._submit_one(fn, c, False)
                   for c in itertools.islice(chunks, self._processes)]
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            nxt = next(chunks, None)
            if nxt is not None:
                pending.append(self._submit_one(fn, nxt, False))
            for ref in ready:
                yield from ray_tpu_torch.get(ref)

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        """Blocks until all submitted work has finished (the stdlib
        close/join completion barrier)."""
        if not self._closed:
            raise ValueError("join() before close()")
        if self._outstanding:
            ray_tpu_torch.wait(self._outstanding,
                         num_returns=len(self._outstanding), timeout=None)
            self._outstanding = []

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()
