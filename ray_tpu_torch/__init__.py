"""ray_tpu_torch — the PyTorch + CUDA port of ray_tpu's serving and
single-card training paths.

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

Submodules import lazily (PEP 562), as in ``ray_tpu.llm``.
"""

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

__all__ = list(_LAZY)


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
