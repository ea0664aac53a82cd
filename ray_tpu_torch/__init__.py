"""ray_tpu_torch — the PyTorch + CUDA port of ray_tpu's serving,
single-card training and RLlib paths.

The runtime is the JAX package's local mode, copied (``core/``,
``remote_function.py``, ``actor.py``, ``exceptions.py``):
``init(local_mode=True)``, then tasks and actors through ``remote`` and
``get``/``put``/``wait``, run as threads of this process. The cluster
runtime is not part of this package yet, so ``init()`` without
``local_mode=True`` raises. ``init`` registers ``shutdown`` to run at
the interpreter's exit, so that actor threads still inside torch code
are joined before the interpreter goes. RLlib (``rllib/``: PPO, IMPALA,
DQN, SAC and BC with their env runners), the datasets of ``data/`` and
Tune (``tune/``) run on it.

The Llama and Mixtral models and their losses, the MLP, and the routed
MoE FFN (``parallel/moe.py``); the ragged paged-KV attention and flash
attention forward and backward (hand-written CUDA C++ kernels for Hopper
under ``ops/csrc/``, each with a plain PyTorch version beside it); the
continuous-batching ``InferenceEngine`` with its flight recorder and
gauges, the ``LLMServer`` front end and ``LLMBatchPredictor``; the train
step, the ``Adafactor`` optimizer and the step profiler; the jax-free
metrics, trace-context and log planes under ``util/``. Module names match the JAX package
(``ray_tpu``) so each counterpart is easy to find; this package imports
neither ``jax`` nor anything of ``ray_tpu``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where every kernel's plain version runs instead.

Submodules beyond the runtime import lazily (PEP 562), as in
``ray_tpu.llm``.
"""

from __future__ import annotations

import atexit
from typing import Dict, Optional

from ray_tpu_torch import exceptions
from ray_tpu_torch.actor import ActorHandle, get_actor
from ray_tpu_torch.core.generator import ObjectRefGenerator
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.worker import global_worker, require_connected
from ray_tpu_torch.remote_function import remote_decorator as remote

_RUNTIME = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "method", "get_runtime_context",
    "cluster_resources", "available_resources", "nodes", "ObjectRef", "ObjectRefGenerator", "ActorHandle", "exceptions",
]


def init(address: Optional[str] = None, *, num_cpus: Optional[int] = None,
         num_gpus: Optional[int] = None,
         resources: Optional[Dict[str, float]] = None,
         local_mode: bool = False,
         ignore_reinit_error: bool = False) -> Dict[str, str]:
    """Start the in-process runtime: ``local_mode=True`` runs tasks on a
    thread pool and each actor on a thread of its own (reference
    local-mode semantics). The cluster runtime is not ported yet, so
    anything else raises. ``shutdown`` runs at the interpreter's exit
    unless the caller ran it before."""
    if global_worker.connected:
        if ignore_reinit_error:
            return {"address": "existing"}
        raise RuntimeError("ray_tpu_torch.init() called twice "
                           "(pass ignore_reinit_error=True to tolerate)")
    if not local_mode:
        raise NotImplementedError(
            "ray_tpu_torch.init() supports local mode only "
            "(init(local_mode=True)); the cluster runtime is not ported "
            "yet")
    merged = dict(resources or {})
    if num_gpus is not None:
        merged["GPU"] = float(num_gpus)
    global_worker.connect_local(num_cpus=num_cpus, resources=merged)
    # a thread still inside torch code when the interpreter exits aborts
    # the process: join the actor threads first (disconnect does)
    atexit.register(shutdown)
    return {"address": "local"}


def shutdown() -> None:
    atexit.unregister(shutdown)
    if global_worker.connected:
        global_worker.disconnect()


def is_initialized() -> bool:
    return global_worker.connected


def get(refs, *, timeout: Optional[float] = None):
    return require_connected().get(refs, timeout=timeout)


def put(value) -> ObjectRef:
    return require_connected().put(value)


def wait(refs, *, num_returns: int = 1, timeout: Optional[float] = None,
         fetch_local: bool = True):
    return require_connected().wait(refs, num_returns=num_returns,
                                    timeout=timeout, fetch_local=fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    require_connected().kill_actor(actor.actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False,
           recursive: bool = True) -> None:
    require_connected().cancel_task(ref, force=force, recursive=recursive)


def cluster_resources() -> Dict[str, float]:
    return require_connected().backend.cluster_resources()


def available_resources() -> Dict[str, float]:
    return require_connected().backend.available_resources()


def nodes() -> list:
    return require_connected().backend.nodes()


def method(**opts):
    """Decorator carrying per-method defaults (e.g. num_returns) on actors."""
    def wrap(fn):
        fn.__rtpu_method_options__ = opts
        return fn
    return wrap


class _RuntimeContext:
    @property
    def job_id(self):
        return global_worker.job_id

    @property
    def node_id(self):
        return global_worker.node_id

    @property
    def worker_id(self):
        return global_worker.worker_id

    @property
    def task_id(self):
        return global_worker.current_task_id

    def get(self) -> Dict[str, str]:
        return {
            "job_id": self.job_id.hex(),
            "worker_id": self.worker_id.hex(),
        }


def get_runtime_context() -> _RuntimeContext:
    return _RuntimeContext()


_LAZY = {
    "LlamaConfig": ("ray_tpu_torch.models.llama", "LlamaConfig"),
    "init_params": ("ray_tpu_torch.models.llama", "init_params"),
    "forward": ("ray_tpu_torch.models.llama", "forward"),
    "loss_fn": ("ray_tpu_torch.models.llama", "loss_fn"),
    "MLPConfig": ("ray_tpu_torch.models.mlp", "MLPConfig"),
    "mlp_init": ("ray_tpu_torch.models.mlp", "mlp_init"),
    "mlp_apply": ("ray_tpu_torch.models.mlp", "mlp_apply"),
    "make_train_step": ("ray_tpu_torch.train.train_step", "make_train_step"),
    "profile_train_step": ("ray_tpu_torch.train.step_profiler",
                           "profile_train_step"),
    "PageAllocator": ("ray_tpu_torch.llm.cache", "PageAllocator"),
    "PrefixCache": ("ray_tpu_torch.llm.cache", "PrefixCache"),
    "make_kv_cache": ("ray_tpu_torch.llm.cache", "make_kv_cache"),
    "InferenceEngine": ("ray_tpu_torch.llm.engine", "InferenceEngine"),
    "LLMServer": ("ray_tpu_torch.llm.serve_llm", "LLMServer"),
    "LLMBatchPredictor": ("ray_tpu_torch.llm.batch", "LLMBatchPredictor"),
    "Adafactor": ("ray_tpu_torch.train.optim", "Adafactor"),
}

__all__ = _RUNTIME + list(_LAZY)


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib
    value = getattr(importlib.import_module(mod_name), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
