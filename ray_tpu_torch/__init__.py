"""ray_tpu_torch — the PyTorch + CUDA port of ray_tpu's serving path.

The Llama model, the ragged paged-KV attention (a hand-written CUDA C++
kernel for Hopper, ``ops/csrc/ragged_paged_attention.cu``, with a plain
PyTorch version beside it), the continuous-batching ``InferenceEngine``
and the ``LLMServer`` front end. Module names match the JAX package
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
    "PageAllocator": ("ray_tpu_torch.llm.cache", "PageAllocator"),
    "PrefixCache": ("ray_tpu_torch.llm.cache", "PrefixCache"),
    "make_kv_cache": ("ray_tpu_torch.llm.cache", "make_kv_cache"),
    "InferenceEngine": ("ray_tpu_torch.llm.engine", "InferenceEngine"),
    "LLMServer": ("ray_tpu_torch.llm.serve_llm", "LLMServer"),
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
