"""ray_tpu_torch — the PyTorch + CUDA port of ray_tpu: its runtime,
serving, single-card training, RLlib, data and Tune.

The runtime is the JAX package's, copied (``core/``, ``runtime/``,
``_native/``, ``remote_function.py``, ``actor.py``, ``exceptions.py``):
``init()`` boots a head, a node daemon and a shared-memory object store as
subprocesses and connects as the driver, so tasks and actors run in
worker processes; a ``num_gpus=n`` lease gets a worker of its own that
sees only its cards (``accelerators/gpu.py``). Tensors cross processes
as host memory and arrive as CPU tensors (``core/serialization.py``).
``init(local_mode=True)`` runs tasks and actors as threads of this
process instead. ``init`` registers ``shutdown`` to run at the
interpreter's exit, so that actor threads still inside torch code are
joined, and the daemons stopped, before the interpreter goes. RLlib
(``rllib/``: PPO, IMPALA, DQN, SAC and BC with their env runners), the
datasets of ``data/`` and Tune (``tune/``) run on either mode; Serve
(``serve/``: deployments, the router, the HTTP and gRPC ingress) on the
cluster runtime. ``fn.bind(...)`` builds lazy DAGs (``dag.py``:
``experimental_compile`` captures a graph of pure stages in CUDA graphs,
or pipelines an actor chain over shm channels, ``runtime/channel.py``),
which durable workflows (``workflow.py``) run step by step. The runtime's modules never import torch: the daemons
stay free of it.

The Llama and Mixtral models and their losses, the MLP, and the routed
MoE FFN (``parallel/moe.py``); the ragged paged-KV attention and flash
attention forward and backward (hand-written CUDA C++ kernels for Hopper
under ``ops/csrc/``, each with a plain PyTorch version beside it); the
continuous-batching ``InferenceEngine`` with its flight recorder and
gauges, the ``LLMServer`` front end and ``LLMBatchPredictor``; the train
step, the ``Adafactor`` optimizer and the step profiler; distributed
training (``train/``: ``TorchTrainer`` over worker processes joined in
one torch.distributed group, NCCL on the card and gloo on the CPU; the
device mesh, collectives and fsdp gathers of ``parallel/``; sharded
checkpoints in the JAX package's format); the jax-free
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
from typing import Any, Dict, Optional

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
         object_store_memory: Optional[int] = None,
         namespace: str = "default",
         ignore_reinit_error: bool = False,
         _system_config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Connect this process to a cluster, starting one if needed.

    - ``local_mode=True``: tasks on a thread pool and each actor on a
      thread of its own (reference local-mode semantics).
    - ``address=None``: boot a head, a node daemon and its shm store as
      subprocesses of this machine, and connect as the driver; tasks and
      actors run in worker processes. The node counts the machine's GPUs
      unless ``num_gpus`` says how many to advertise; a ``num_gpus=n``
      task or actor gets a worker of its own that sees only its ``n``
      cards through ``CUDA_VISIBLE_DEVICES``.
    - ``address="host:port"``: connect to an existing head.

    ``shutdown`` runs at the interpreter's exit unless the caller ran it
    before."""
    if global_worker.connected:
        if ignore_reinit_error:
            return {"address": "existing"}
        raise RuntimeError("ray_tpu_torch.init() called twice "
                           "(pass ignore_reinit_error=True to tolerate)")
    # fresh table per session: a previous init()'s _system_config in this
    # process must not leak into this cluster
    from ray_tpu_torch.core.config import GlobalConfig, reset_to_defaults
    reset_to_defaults()
    if _system_config:
        GlobalConfig.apply(_system_config)
    if local_mode:
        merged = dict(resources or {})
        if num_gpus is not None:
            merged["GPU"] = float(num_gpus)
        global_worker.connect_local(num_cpus=num_cpus, resources=merged)
        info = {"address": "local"}
    else:
        from ray_tpu_torch.runtime.cluster_backend import connect_or_start
        info = connect_or_start(
            global_worker, address=address, num_cpus=num_cpus,
            num_gpus=num_gpus, resources=resources,
            object_store_memory=object_store_memory, namespace=namespace)
    # a thread still inside torch code when the interpreter exits aborts
    # the process: join the actor threads first, and stop the daemons
    # this driver started (disconnect does both)
    atexit.register(shutdown)
    return info


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
