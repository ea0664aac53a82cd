"""LLM engine defaults — the port's own copy of the ``llm_*`` entries of
``ray_tpu/core/config.py``.

Each default can be overridden with the same ``RTPU_<name>`` environment
variable the JAX package reads, at the time ``llm_defaults()`` is called.
"""

from __future__ import annotations

import os
from typing import Any, Dict

_ENV_PREFIX = "RTPU_"

# name -> (type, default, help)
_LLM_DEFS: Dict[str, tuple] = {
    "llm_prefix_cache": (bool, True, "share page-aligned prompt-prefix KV pages across requests (LRU-evicted under allocator pressure)"),
    "llm_prefill_chunk": (int, 512, "prompts (or uncached tails) longer than this prefill in chunks interleaved with decode steps"),
    "llm_step_token_budget": (int, 2048, "max prefill tokens scheduled per engine step (decode-priority continuous batching); 0 = unbounded"),
    "llm_admit_lookahead": (int, 16, "waiting requests scanned past a non-admittable head (head-of-line fix)"),
    "llm_admit_age_cap_s": (float, 5.0, "a head request older than this stops lookahead skipping so freed pages go to it first"),
    "llm_kv_dtype": (str, "model", "KV page storage scheme: 'model' (engine dtype) or 'int8' (quantized pages + bf16 per-token scales)"),
    "llm_ragged_prefill_rows": (int, 2, "prefill-chunk rows packed into each ragged step (ragged token capacity = max_batch + rows*prefill_chunk)"),
}


def _parse(typ, raw: str) -> Any:
    if typ is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return typ(raw)


def llm_defaults() -> Dict[str, Any]:
    """{name: value} for every ``llm_*`` default, env overrides applied."""
    out = {}
    for name, (typ, default, _help) in _LLM_DEFS.items():
        env = os.environ.get(_ENV_PREFIX + name)
        out[name] = default if env is None else _parse(typ, env)
    return out
