"""int8 KV pools under memory pressure: the port's engine against the JAX
package's int8 engine, on the CPU.

The programs are tests/test_llm.py's int8 cases and tests/test_torch_llm.py's
prefix-cow, prefix-evict and recompute-preemption scenarios, run with
``kv_dtype="int8"`` on both engines with the JAX package's parameters
(carried across with ``convert``). Each engine keeps the JAX test's
invariants, the counts are equal, and the port's streams equal the JAX
int8 engine's up to a parting where the fp oracle's top-2 margin sits
under the int8 noise (``INT8_LOGIT_NOISE``), as the int8 engine test of
tests/test_torch_llm.py compares them.
"""

import jax.numpy as jnp
import pytest
import torch

from ray_tpu.llm.cache import make_kv_cache as j_make_kv_cache
from ray_tpu.llm.engine import InferenceEngine as JEngine
from ray_tpu.models import llama as jl
from ray_tpu_torch.llm.cache import make_kv_cache as t_make_kv_cache
from ray_tpu_torch.llm.engine import InferenceEngine as TEngine
from ray_tpu_torch.models import llama as tl
from test_torch_llm import (INT8_LOGIT_NOISE, JCFG, SCENARIOS, TCFG, V,
                            _prompt, _top2_margin, params)  # noqa: F401

torch.set_num_threads(1)


def held_streams(jp, pairs):
    """Each (prompt, port stream, JAX stream): equal up to their first
    parting, where the fp oracle's top-2 margin must sit under the int8
    noise. -> tokens compared equal."""
    compared = 0
    for prompt, got, want in pairs:
        assert len(got) == len(want), (prompt, got, want)
        for i, (a, b) in enumerate(zip(got, want)):
            if a != b:
                margin = _top2_margin(jp, list(prompt) + list(want[:i]))
                assert margin < INT8_LOGIT_NOISE, \
                    f"int8 streams part at a clear margin {margin}"
                break
            compared += 1
    return compared


def prefix_hit_cow_and_evict(eng):
    """tests/test_llm.py::test_int8_kv_prefix_hit_cow_and_evict's program
    with its invariants checked on ``eng``. -> ([(prompt, stream)], counts).
    """
    base = [(7 * i + 3) % V for i in range(16)]
    cold = eng.generate(base + [9], 6)
    rid = eng.add_request(base + [9], 6)         # full 2-page hit
    done = {}
    for _ in range(100):
        done.update(eng.step())
        if rid in done:
            break
    assert done[rid] == cold, "int8 prefix hit changed the stream"
    cached = eng.cached_tokens(rid)
    cow_cold = eng.generate(base, 6)             # exact page multiple
    cow0 = eng.stats["cow_copies"]
    cow_hit = eng.generate(base, 6)              # COW on the shared page
    assert eng.stats["cow_copies"] == cow0 + 1
    assert cow_hit == cow_cold, "int8 COW changed the stream"
    streams = [(base + [9], cold), (base, cow_cold)]
    for m in (11, 13, 17):   # distinct 5-page prompts overflow the pool
        big = [(m * i + 5) % V for i in range(40)]
        first = eng.generate(big, 4)
        assert eng.generate(big, 4) == first
        streams.append((big, first))
    assert eng.prefix.evictions >= 1, "no eviction under pressure"
    return streams, (cached, eng.stats["cow_copies"], eng.prefix.evictions)


def test_int8_kv_prefix_hit_cow_and_evict_matches_jax(params):
    jp, tp = params
    kw = dict(page_size=8, total_pages=16, max_batch=2, max_seq_len=64,
              prefill_chunk=8, kv_dtype="int8")
    want, want_counts = prefix_hit_cow_and_evict(JEngine(JCFG, jp, **kw))
    eng = TEngine(TCFG, tp, device="cpu", **kw)
    assert eng.kv["k"].dtype == torch.int8 and len(eng.kv) == 4
    got, got_counts = prefix_hit_cow_and_evict(eng)
    assert got_counts == want_counts
    assert got_counts[0] == 16
    pairs = [(p, g, w) for (p, g), (_, w) in zip(got, want)]
    assert held_streams(jp, pairs) >= 20


@pytest.mark.parametrize("head_dim", [64, 128])
def test_int8_kv_capacity_ratio_matches_jax(head_dim):
    """tests/test_llm.py::test_int8_kv_capacity_ratio at head dim 64 and
    at the 8B model's 128: both packages' pools take the same bytes, and
    the int8 pool (pages and bf16 scales) fits at least 1.9x the pages of
    a bf16 pool in them."""
    dims = dict(vocab_size=128, dim=8 * head_dim, n_layers=2, n_heads=8,
                n_kv_heads=4, ffn_dim=1024)
    jcfg = jl.LlamaConfig(**dims, dtype=jnp.bfloat16)
    tcfg = tl.LlamaConfig(**dims, dtype=torch.bfloat16)
    assert jcfg.head_dim == tcfg.head_dim == head_dim
    counts = {}
    for kv in (None, "int8"):
        j = j_make_kv_cache(jcfg, total_pages=8, page_size=32, kv_dtype=kv)
        t = t_make_kv_cache(tcfg, total_pages=8, page_size=32, kv_dtype=kv,
                            device="cpu")
        counts[kv] = sum(leaf.nbytes for leaf in j.values())
        assert sum(x.numel() * x.element_size() for x in t.values()) == \
            counts[kv]
        assert {k: tuple(v.shape) for k, v in t.items()} == \
            {k: tuple(v.shape) for k, v in j.items()}
    ratio = counts[None] / counts["int8"]
    assert ratio >= 1.9, f"int8 KV capacity ratio {ratio:.3f} < 1.9"
    assert ratio == 2 * head_dim / (head_dim + 2)


def _scenario_streams(name, out):
    """The scenario's result split into ([(prompt, stream)], the rest)."""
    if name == "prefix_cow":
        cold, hit, *rest = out
        prompt = _prompt(9, 4, 16)
        return [(prompt, cold), (prompt, hit)], rest
    if name == "prefix_evict":
        small, evictable, big, evicted = out
        return [(_prompt(2, 1, 16), small), (_prompt(13, 7, 40), big)], \
            [evictable, evicted]
    streams, preemptions = out
    return [(list(range(1, 9)), streams[0]),
            (list(range(3, 11)), streams[1])], [preemptions]


@pytest.mark.parametrize("name", ["prefix_cow", "prefix_evict",
                                  "preemption_recompute"])
def test_int8_scenarios_match_jax_int8_engine(params, name):
    """tests/test_torch_llm.py's scenario with int8 pools on both engines:
    the counts equal, the streams under the int8 margin rule."""
    jp, tp = params
    kw, scenario = SCENARIOS[name]
    kw = dict(kw, kv_dtype="int8")
    want, want_rest = _scenario_streams(name,
                                        scenario(JEngine(JCFG, jp, **kw)))
    got, got_rest = _scenario_streams(
        name, scenario(TEngine(TCFG, tp, device="cpu", **kw)))
    assert got_rest == want_rest
    if name == "prefix_cow":
        assert got_rest == [1, 15]              # one copy, 15 cached
    elif name == "prefix_evict":
        assert got_rest[1] is True
    else:
        assert got_rest[0] >= 1
    pairs = [(pr, g, w) for (pr, g), (_, w) in zip(got, want)]
    assert held_streams(jp, pairs) >= sum(len(w) for _, w in want) // 2
