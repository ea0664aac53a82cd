"""joblib backend over cluster tasks.

Role-equivalent to the reference's ray.util.joblib
(reference: python/ray/util/joblib/__init__.py +
ray_backend.py): ``register_ray_tpu_torch()`` then
``joblib.parallel_backend("ray_tpu_torch")`` runs scikit-learn style
``Parallel(n_jobs=...)(delayed(f)(x) ...)`` loops as cluster tasks.

The port of ``ray_tpu/util/joblib_backend.py``. ``joblib`` is imported
only by ``register_ray_tpu_torch``: nothing else of this package needs it.

Built on joblib's public ParallelBackendBase plugin seam; each joblib
"job" is one remote task wrapping the batch callable joblib hands us.
"""

from __future__ import annotations

from typing import Any, Callable

import ray_tpu_torch


def _run_batch(batch_blob: bytes) -> Any:
    import cloudpickle
    items = cloudpickle.loads(batch_blob)
    return [fn(*args, **kwargs) for fn, args, kwargs in items]


_BATCH_TASK = None


def _batch_task():
    """One RemoteFunction for all batches (per-call construction would
    redo option validation and defeat the export cache)."""
    global _BATCH_TASK
    if _BATCH_TASK is None:
        _BATCH_TASK = ray_tpu_torch.remote(_run_batch)
    return _BATCH_TASK


def register_ray_tpu_torch() -> None:
    """Register the 'ray_tpu_torch' joblib parallel backend (reference:
    ray.util.joblib.register_ray)."""
    from joblib.parallel import ParallelBackendBase, register_parallel_backend

    class RayTpuTorchBackend(ParallelBackendBase):
        supports_timeout = True

        def configure(self, n_jobs: int = 1, parallel=None, **kwargs):
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init()
            self.parallel = parallel
            return self.effective_n_jobs(n_jobs)

        def effective_n_jobs(self, n_jobs: int) -> int:
            if n_jobs == 0:
                raise ValueError("n_jobs == 0 has no meaning")
            if n_jobs < 0:
                total = ray_tpu_torch.cluster_resources().get("CPU", 1.0)
                return max(1, int(total))
            return n_jobs

        def apply_async(self, func: Callable, callback=None):
            from ray_tpu_torch.util.multiprocessing import _dumps_by_value
            # ship the batch's raw (fn, args, kwargs) items, not the
            # BatchedCalls object: that wrapper drags joblib backend
            # state (thread-locals) that cannot pickle, and the items
            # are the whole contract anyway
            items = list(getattr(func, "items", ()))
            if not items:
                raise TypeError(
                    f"unsupported joblib batch type {type(func).__name__}")
            blob = _dumps_by_value(items)
            ref = _batch_task().remote(blob)
            return _RefFuture(ref, callback)

        def abort_everything(self, ensure_ready: bool = True):
            pass  # tasks are fire-and-forget; refs die with the futures

    class _RefFuture:
        def __init__(self, ref, callback):
            self._ref = ref
            self._callback = callback
            if callback is not None:
                # joblib drives progress through callbacks; resolve on a
                # waiter thread so apply_async stays non-blocking
                import threading

                def waiter():
                    try:
                        # readiness only — fetching here would
                        # deserialize the value once for the callback
                        # and AGAIN in joblib's retrieval path
                        ray_tpu_torch.wait([ref], num_returns=1, timeout=None)
                    except Exception:  # noqa: BLE001 — surfaced by
                        pass           # get() in joblib's retrieval
                    callback(self)
                threading.Thread(target=waiter, daemon=True).start()

        def get(self, timeout=None):
            return ray_tpu_torch.get(self._ref, timeout=timeout)

    register_parallel_backend("ray_tpu_torch", RayTpuTorchBackend)
