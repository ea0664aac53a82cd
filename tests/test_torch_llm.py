"""PyTorch port of the LLM engine against the JAX package, on the CPU.

The JAX side runs as tests/test_llm.py runs it (gather references); the
port runs its plain attention on CPU tensors. Parameters are the JAX
package's, carried across with ``ray_tpu_torch.convert``; descriptors and
pools come from a numpy seed. Engine cases are tests/test_llm.py's,
driven the same way on both engines, whose greedy streams and scheduler
stats must be equal.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import model as jm
from ray_tpu.llm.engine import InferenceEngine as JEngine
from ray_tpu.models import llama as jl
from ray_tpu.ops.int8 import KV_SCALE_DTYPE as J_SCALE
from ray_tpu_torch import convert
from ray_tpu_torch.llm import cache as tc
from ray_tpu_torch.llm import model as tm
from ray_tpu_torch.llm.engine import InferenceEngine as TEngine
from ray_tpu_torch.llm.serve_llm import LLMServer
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops.int8 import KV_SCALE_DTYPE as T_SCALE

# tiny shapes: one intra-op thread, leaving the cores to the tests
# that run beside these ones
torch.set_num_threads(1)

JCFG = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
V = JCFG.vocab_size

# fp32 pools on both sides: K/V differ by summation order only
POOL_ATOL = 1e-5
# int8 round-trip noise on this model's logits is ~1e-2 (the near-tie
# ROADMAP Queue 3 records has a top-2 margin of 0.011); a wrong-page read
# moves logits by O(1)
INT8_LOGIT_NOISE = 0.05


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(7))
    return jp, convert.from_jax(jp, device="cpu")


# ----------------------------------------------------------- step programs


def _ragged_batch(seed, P=16, ps=8, int8=False):
    """2 decode rows, 1 inactive row, a 6-token chunk straddling a page
    boundary and a 4-token first chunk; tokens 13..15 are padding."""
    rng = np.random.default_rng(seed)
    L, Hkv, D = JCFG.n_layers, JCFG.n_kv_heads, JCFG.head_dim
    shape = (L, P, Hkv, ps, D)
    if int8:
        kv = {"k": rng.integers(-127, 128, shape, dtype=np.int8),
              "v": rng.integers(-127, 128, shape, dtype=np.int8),
              "k_scale": rng.uniform(0.005, 0.02, shape[:-1]),
              "v_scale": rng.uniform(0.005, 0.02, shape[:-1])}
    else:
        kv = {"k": rng.standard_normal(shape, np.float32),
              "v": rng.standard_normal(shape, np.float32)}
    pt = np.array([[1, 2, 0, 0], [3, 4, 5, 0], [0, 0, 0, 0],
                   [6, 7, 8, 0], [9, 0, 0, 0]], np.int32)
    q_start = np.array([0, 1, 0, 2, 8], np.int32)
    q_len = np.array([1, 1, 0, 6, 4], np.int32)
    kv_len = np.array([11, 20, 0, 21, 4], np.int32)
    T = 16
    tokens = rng.integers(0, V, T).astype(np.int32)
    token_pos = np.zeros(T, np.int32)
    token_page = np.zeros(T, np.int32)
    token_slot = np.zeros(T, np.int32)
    for r in range(len(q_start)):
        for j in range(q_len[r]):
            t = q_start[r] + j
            pos = kv_len[r] - q_len[r] + j
            token_pos[t] = pos
            token_page[t] = pt[r, pos // ps]
            token_slot[t] = pos % ps
    args = (tokens, token_pos, token_page, token_slot, pt, q_start, q_len,
            kv_len)
    return args, kv


def _jkv(kv):
    out = {k: jnp.asarray(v) for k, v in kv.items()}
    for k in ("k_scale", "v_scale"):
        if k in out:
            out[k] = out[k].astype(J_SCALE)
    return out


def _tkv(kv):
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in kv.items()}
    for k in ("k_scale", "v_scale"):
        if k in out:
            # the same bf16 values as the JAX side
            out[k] = torch.from_numpy(np.array(
                jnp.asarray(kv[k]).astype(J_SCALE).astype(jnp.float32))
            ).to(T_SCALE)
    return out


def _assert_pools_close(tkv, jkv):
    for name, j in jkv.items():
        t = tkv[name]
        jf = np.asarray(j.astype(jnp.float32))
        if t.dtype == torch.int8:
            # a value sitting on a rounding boundary may land one step off
            assert np.abs(t.numpy().astype(int) - np.asarray(j)).max() <= 1
        elif t.dtype == torch.bfloat16:
            np.testing.assert_allclose(t.float().numpy(), jf, rtol=1e-2)
        else:
            np.testing.assert_allclose(t.numpy(), jf, atol=POOL_ATOL)


@pytest.mark.parametrize("int8", [False, True])
def test_ragged_step_matches_jax(params, int8):
    jp, tp = params
    args, kv = _ragged_batch(0, int8=int8)
    jnxt, jkv = jm.ragged_step(jp, *map(jnp.asarray, args), _jkv(kv),
                               cfg=JCFG, paged_impl="reference",
                               max_q_len=6, decode_rows=3)
    tkv = _tkv(kv)
    tnxt, tkv2 = tm.ragged_step([tp], *map(torch.from_numpy, args), [tkv],
                                TCFG, max_q_len=6, decode_rows=3)
    assert tkv2[0] is tkv                  # the pool is updated in place
    assert tnxt.dtype == torch.int32
    np.testing.assert_array_equal(tnxt.numpy(), np.asarray(jnxt))
    _assert_pools_close(tkv, jkv)


def test_ragged_decode_loop_matches_jax(params):
    jp, tp = params
    _, kv = _ragged_batch(1)
    tokens = np.array([3, 77, 0, 150], np.int32)
    positions = np.array([10, 19, 0, 4], np.int32)
    pt = np.array([[1, 2, 0, 0], [3, 4, 5, 0], [0, 0, 0, 0],
                   [9, 0, 0, 0]], np.int32)
    seq_lens = np.array([11, 20, 1, 5], np.int32)   # slot 2 inactive
    args = (tokens, positions)
    jout, jkv, jpos, jlens = jm.ragged_decode_loop(
        jp, *map(jnp.asarray, args), _jkv(kv), jnp.asarray(pt),
        jnp.asarray(seq_lens), num_steps=3, cfg=JCFG,
        paged_impl="reference")
    tkv = _tkv(kv)
    tout, _, tpos, tlens = tm.ragged_decode_loop(
        [tp], *map(torch.from_numpy, args), [tkv], torch.from_numpy(pt),
        torch.from_numpy(seq_lens), num_steps=3, cfg=TCFG)
    assert tuple(tout.shape) == (3, 4)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    _assert_pools_close(tkv, jkv)


@pytest.mark.parametrize("int8", [False, True])
def test_copy_page_matches_jax(int8):
    _, kv = _ragged_batch(2, int8=int8)
    jkv = jm.copy_page(_jkv(kv), jnp.int32(3), jnp.int32(11))
    tkv = tm.copy_page(_tkv(kv), 3, 11)
    for name, j in jkv.items():
        np.testing.assert_array_equal(tkv[name].float().numpy(),
                                      np.asarray(j.astype(jnp.float32)))
    assert torch.equal(tkv["k"][:, 11], tkv["k"][:, 3])


# ------------------------------------------------------ engine scenarios
#
# Each scenario drives one engine through tests/test_llm.py's case and
# returns what that test checks (streams in request order, stats); the
# JAX engine and the port's must return the same.


def _run(eng, rids, limit=200):
    done = {}
    for _ in range(limit):
        done.update(eng.step())
        if all(r in done for r in rids):
            break
    return [done[r] for r in rids]


def _prompt(mult, add, n):
    return [(mult * i + add) % V for i in range(n)]


def sc_full_forward_greedy(eng):
    return eng.generate([5, 17, 42, 9, 100, 3, 77], max_new_tokens=12)


def sc_prompt_padding_invariance(eng):
    return [eng.generate(_prompt(3, 1, n), 6) for n in (1, 7, 8, 9, 16, 17)]


def sc_continuous_batching(eng):
    prompts = [[11, 22, 33], [101, 5], [60, 61, 62, 63, 64]]
    rids = [eng.add_request(p, 8) for p in prompts]
    return _run(eng, rids), eng.stats["decode_dispatches"]


def sc_eos_and_page_recycling(eng):
    free0 = eng.allocator.num_free
    first = eng.generate([5, 17, 42], 3)
    eng.eos_token = first[2]
    got = eng.generate([5, 17, 42], max_new_tokens=10)
    return first, got, eng.allocator.num_free == free0


def sc_multi_prompt_single_dispatch(eng):
    prompts = [[7 + i for i in range(12)], [40 + i for i in range(10)],
               [90 + i for i in range(15)]]
    rids = [eng.add_request(p, 6) for p in prompts]
    eng.step()
    one = eng.stats["ragged_dispatches"]
    return one, _run(eng, rids)


def sc_chunked_prefill(eng):
    got = eng.generate(_prompt(5, 2, 20), max_new_tokens=8)
    return got, eng.stats["ragged_dispatches"]


def sc_prefix_hit(eng):
    prompt = _prompt(7, 3, 20)
    cold = eng.generate(prompt, 8)
    pf0 = eng.stats["prefill_tokens"]
    rid = eng.add_request(prompt, 8)
    (hit,) = _run(eng, [rid])
    return (cold, hit, eng.stats["cached_tokens"], eng.cached_tokens(rid),
            eng.stats["prefill_tokens"] - pf0)


def sc_prefix_partial_hit(eng):
    a = _prompt(3, 2, 20)
    b = a[:8] + _prompt(11, 5, 12)
    cold = eng.generate(a, 6)
    rid = eng.add_request(b, 6)
    return cold, _run(eng, [rid]), eng.cached_tokens(rid)


def sc_prefix_cow(eng):
    prompt = _prompt(9, 4, 16)
    cold = eng.generate(prompt, 6)
    rid = eng.add_request(prompt, 6)
    return (cold, _run(eng, [rid]), eng.stats["cow_copies"],
            eng.cached_tokens(rid))


def sc_prefix_evict(eng):
    small = eng.generate(_prompt(2, 1, 16), 4)
    evictable = eng.prefix.num_evictable
    big = eng.generate(_prompt(13, 7, 40), 4)
    return small, evictable, big, eng.prefix.evictions >= 1


def sc_decode_interleaves_with_chunked_prefill(eng):
    eng.add_request([9, 4, 33, 2, 71], 28)
    eng.step()
    d0 = eng.stats["decode_tokens"]
    rb = eng.add_request(_prompt(5, 1, 40), 4)
    for _ in range(20):
        eng.step()
        if not any(s.request_id == rb for s in eng._chunking):
            break
    # the streams themselves: test_engine_decode_interleave_streams_...
    return (eng.stats["ragged_dispatches"], eng.stats["decode_tokens"] > d0,
            eng.stats["decode_dispatches"])


def sc_admission_lookahead(eng):
    eng.add_request(_prompt(2, 1, 24), 30)
    eng.step()
    rb = eng.add_request(_prompt(3, 2, 17), 4)
    rc = eng.add_request([11, 5, 42, 7, 9, 1, 3], 4)
    eng.step()
    waiting = {s.request_id for s in eng.waiting}
    return rb in waiting, rc in waiting


def sc_mixed_length_prompts(eng):
    rids = [eng.add_request([5, 6, 7], 5),
            eng.add_request([20 + i for i in range(20)], 5)]
    eng.step()
    one = eng.stats["ragged_dispatches"]
    return one, _run(eng, rids)


def sc_preemption(eng):
    rids = [eng.add_request(list(range(1, 9)), 16),
            eng.add_request(list(range(3, 11)), 16)]
    return _run(eng, rids), eng.stats["preemptions"]


BASE = dict(page_size=8, total_pages=64, max_batch=4, max_seq_len=128)
SCENARIOS = {
    "full_forward_greedy": (BASE, sc_full_forward_greedy),
    "prompt_padding_invariance": (BASE, sc_prompt_padding_invariance),
    "continuous_batching": (dict(BASE, total_pages=128),
                            sc_continuous_batching),
    "eos_and_page_recycling": (dict(page_size=8, total_pages=16,
                                    max_batch=2, max_seq_len=64),
                               sc_eos_and_page_recycling),
    "multi_prompt_single_dispatch": (
        dict(BASE, total_pages=128, prefill_chunk=16, prefill_rows=3),
        sc_multi_prompt_single_dispatch),
    "chunked_prefill": (dict(BASE, prefix_cache=False, prefill_chunk=8),
                        sc_chunked_prefill),
    "step_token_budget": (dict(BASE, prefix_cache=False, prefill_chunk=8,
                               step_token_budget=4), sc_chunked_prefill),
    "prefix_hit": (BASE, sc_prefix_hit),
    "prefix_partial_hit": (BASE, sc_prefix_partial_hit),
    "prefix_cow": (BASE, sc_prefix_cow),
    "prefix_evict": (dict(page_size=8, total_pages=8, max_batch=2,
                          max_seq_len=64), sc_prefix_evict),
    "decode_interleaves_with_chunked_prefill": (
        dict(page_size=8, total_pages=128, max_batch=4, max_seq_len=256,
             decode_chunk=4, prefix_cache=False, prefill_chunk=8,
             step_token_budget=8),
        sc_decode_interleaves_with_chunked_prefill),
    "admission_lookahead": (dict(page_size=8, total_pages=8, max_batch=3,
                                 max_seq_len=64, prefix_cache=False),
                            sc_admission_lookahead),
    "admission_aged_head": (dict(page_size=8, total_pages=8, max_batch=3,
                                 max_seq_len=64, prefix_cache=False,
                                 admit_age_cap_s=0.0),
                            sc_admission_lookahead),
    "mixed_length_prompts": (dict(BASE, total_pages=128, prefill_chunk=32),
                             sc_mixed_length_prompts),
    "preemption_recompute": (dict(page_size=4, total_pages=10, max_batch=4,
                                  max_seq_len=32, prefix_cache=False,
                                  decode_chunk=4), sc_preemption),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_greedy_streams_match_jax_engine(params, name):
    jp, tp = params
    kw, scenario = SCENARIOS[name]
    want = scenario(JEngine(JCFG, jp, **kw))
    got = scenario(TEngine(TCFG, tp, device="cpu", **kw))
    assert got == want, f"{name}: port {got} vs JAX {want}"


def test_engine_decode_interleave_streams_match_jax(params):
    """The interleave case's full streams (its scenario above checks the
    scheduling counters)."""
    jp, tp = params
    kw = SCENARIOS["decode_interleaves_with_chunked_prefill"][0]
    out = []
    for eng in (JEngine(JCFG, jp, **kw),
                TEngine(TCFG, tp, device="cpu", **kw)):
        rids = [eng.add_request([9, 4, 33, 2, 71], 28)]
        eng.step()
        rids.append(eng.add_request(_prompt(5, 1, 40), 4))
        out.append(_run(eng, rids))
    assert out[0] == out[1]


def test_preemption_stream_equals_uncontended_run(params):
    """Recompute preemption leaves the greedy streams as an uncontended
    pool gives them."""
    _, tp = params
    kw = dict(SCENARIOS["preemption_recompute"][0])
    streams, n_pre = sc_preemption(TEngine(TCFG, tp, device="cpu", **kw))
    kw["total_pages"] = 64
    ref, n_ref = sc_preemption(TEngine(TCFG, tp, device="cpu", **kw))
    assert n_pre >= 1 and n_ref == 0
    assert streams == ref


def _top2_margin(jparams, toks):
    logits = np.asarray(jl.forward(jparams, jnp.asarray([toks]), JCFG))
    top = np.sort(logits[0, -1])[-2:]
    return float(top[1] - top[0])


def test_int8_engine_matches_jax_int8_engine_margin_aware():
    """int8 KV against the JAX int8 engine, never against fp: tokens are
    compared while the fp oracle's top-2 margin exceeds the int8 noise;
    at a near-tie the two may part, and the comparison stops there."""
    jp = jl.init_params(JCFG, jax.random.PRNGKey(1))   # has a near-tie
    kw = dict(page_size=8, total_pages=64, max_batch=4, max_seq_len=128,
              prefill_chunk=8, kv_dtype="int8")
    je = JEngine(JCFG, jp, **kw)
    te = TEngine(TCFG, convert.from_jax(jp, device="cpu"), device="cpu",
                 **kw)
    assert te.kv["k"].dtype == torch.int8
    assert set(te.kv) == {"k", "v", "k_scale", "v_scale"}
    compared = 0
    for prompt in ([5, 17, 42, 9, 100, 3, 77], _prompt(5, 2, 20),
                   _prompt(7, 3, 11)):
        want = je.generate(prompt, max_new_tokens=10)
        got = te.generate(prompt, max_new_tokens=10)
        for i, (a, b) in enumerate(zip(want, got)):
            if a != b:
                margin = _top2_margin(jp, prompt + want[:i])
                assert margin < INT8_LOGIT_NOISE, \
                    f"int8 streams part at a clear margin {margin}"
                break
            compared += 1
    assert compared >= 10


# ------------------------------------------------------ cache bookkeeping


def test_page_allocator_refcounts_and_double_free():
    a = tc.PageAllocator(8)                  # strict under pytest
    assert a.num_free == 7                   # page 0 reserved
    got = a.alloc(3)
    assert got is not None and 0 not in got and a.alloc(10) is None
    (p,) = a.alloc(1)
    a.incref([p])
    assert a.refcount(p) == 2
    a.free([p])
    assert a.refcount(p) == 1 and a.num_free == 3
    a.free([p])
    a.free(got)
    assert a.refcount(p) == 0 and a.num_free == 7
    with pytest.raises(tc.DoubleFreeError):
        a.free([p])
    with pytest.raises(ValueError):
        a.incref([p])
    relaxed = tc.PageAllocator(8, strict_free=False)
    (q,) = relaxed.alloc(1)
    relaxed.free([q])
    relaxed.free([q])                        # logged and skipped
    assert relaxed.num_free == 7


def test_prefix_cache_match_register_evict():
    a = tc.PageAllocator(16)
    c = tc.PrefixCache(a, page_size=4)
    prompt = list(range(10))
    pages = a.alloc(3)
    c.register(prompt, pages)
    assert c.num_cached == 2
    hit, matched, cow = c.match(prompt)
    assert hit == pages[:2] and matched == 8 and not cow
    hit2, matched2, cow2 = c.match(prompt[:8])
    assert matched2 == 7 and cow2
    hit3, matched3, _ = c.match(prompt[:4] + [99, 98, 97, 96])
    assert hit3 == pages[:1] and matched3 == 4
    for h in (hit, hit2, hit3):
        a.free(h)
        c.note_release(h)
    assert c.num_evictable == 0
    a.free(pages)
    c.note_release(pages)
    assert c.num_evictable == 2
    assert c.evict(5) == 2 and c.num_cached == 0 and a.num_free == 15


def test_kv_tags_and_hash_chains_match_jax():
    from ray_tpu.llm import cache as jc
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        jcfg = jl.LlamaConfig.tiny(dtype=jdt)
        tcfg = tl.LlamaConfig.tiny(dtype=tdt)
        for kv_dtype in (None, "model", "int8"):
            assert tc.kv_cache_tag(tcfg, kv_dtype) == \
                jc.kv_cache_tag(jcfg, kv_dtype)
    assert tc.kv_cache_tag(TCFG, None) == "float32"
    prompt = list(range(21))
    for tag in ("float32", "int8"):
        assert tc.hash_token_blocks(prompt, 8, tag) == \
            jc.hash_token_blocks(prompt, 8, tag)
    assert tc.hash_token_blocks(prompt, 8, "float32") != \
        tc.hash_token_blocks(prompt, 8, "int8")
    a = tc.PageAllocator(16)
    c_fp = tc.PrefixCache(a, page_size=8, kv_tag="float32")
    c_q8 = tc.PrefixCache(a, page_size=8, kv_tag="int8")
    c_fp.register(prompt[:16], a.alloc(2))
    assert c_fp.match(prompt[:16])[1] > 0
    assert c_q8.match(prompt[:16])[:2] == ([], 0)


def test_make_kv_cache_shapes_and_int8_capacity():
    cfg = tl.LlamaConfig(vocab_size=128, dim=512, n_layers=2, n_heads=8,
                         n_kv_heads=4, ffn_dim=1024)
    fp = tc.make_kv_cache(cfg, total_pages=8, page_size=32, device="cpu")
    q8 = tc.make_kv_cache(cfg, total_pages=8, page_size=32,
                          kv_dtype="int8", device="cpu")
    assert tuple(fp["k"].shape) == (2, 8, 4, 32, 64)
    assert fp["k"].dtype == torch.bfloat16
    assert q8["k_scale"].dtype == T_SCALE
    nbytes = [sum(t.numel() * t.element_size() for t in kv.values())
              for kv in (fp, q8)]
    assert nbytes[0] / nbytes[1] >= 1.9
    with pytest.raises(ValueError):
        tc.make_kv_cache(cfg, 8, 32, kv_dtype="fp8", device="cpu")


# ----------------------------------------------------------------- server


def test_llm_server_call_stream_and_completions():
    srv = LLMServer({"n_layers": 2, "dtype": "float32"},
                    {"page_size": 8, "total_pages": 64, "max_batch": 4,
                     "max_seq_len": 128, "seed": 7, "device": "cpu"})
    try:
        ref = TEngine(TCFG, seed=7, page_size=8, total_pages=64,
                      max_batch=4, max_seq_len=128, device="cpu")
        want = ref.generate([5, 17, 42], 6)
        out = srv({"prompt_ids": [5, 17, 42], "max_tokens": 6})
        assert out["token_ids"] == want
        chunks = list(srv.stream({"prompt_ids": [5, 17, 42],
                                  "max_tokens": 6}))
        assert chunks[-1]["done"] and chunks[-1]["token_ids"] == want
        streamed = [t for c in chunks[:-1] for t in c["token_ids"]]
        assert streamed == want and len(chunks) >= 2
        body = srv.completions({"prompt": "hi", "max_tokens": 4})
        assert body["object"] == "text_completion"
        assert body["usage"]["completion_tokens"] == 4
        assert body["choices"][0]["finish_reason"] == "length"
        chat = srv.chat_completions({"messages": [
            {"role": "user", "content": "hello"}], "max_tokens": 3})
        assert chat["usage"]["completion_tokens"] == 3
        parts = list(srv.completions_stream({"prompt": "hi",
                                             "max_tokens": 4}))
        assert parts[-1]["usage"]["completion_tokens"] == 4
        assert srv.stats()["prefix_cache"]["lookups"] >= 4
        srv.check_health()
    finally:
        srv.shutdown()
    assert not srv._thread.is_alive()


def test_llm_server_concurrent_requests_share_steps():
    import threading
    srv = LLMServer({"n_layers": 2, "dtype": "float32"},
                    {"page_size": 8, "total_pages": 64, "max_batch": 4,
                     "max_seq_len": 128, "seed": 7, "device": "cpu"})
    try:
        outs = [None] * 3
        prompts = [[5, 17, 42], [5, 17, 42], [9, 9, 1, 2]]

        def call(i):
            outs[i] = srv({"prompt_ids": prompts[i], "max_tokens": 6})

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
            assert not t.is_alive()
        assert all(len(o["token_ids"]) == 6 for o in outs)
        assert outs[0]["token_ids"] == outs[1]["token_ids"]
        assert srv.stats()["decode_dispatches"] < 9
    finally:
        srv.shutdown()


def test_engine_requires_card_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        TEngine(TCFG, total_pages=4, max_batch=1, max_seq_len=16)


def test_engine_on_a_card_checks_the_kernel_geometry_first(monkeypatch):
    """On a CUDA device the constructor checks the attention kernels'
    geometry before it allocates anything, so the default server (preset
    "tiny", head dim 8) raises at construction and starts no engine
    thread. The device is stood in for here: resolve_device hands back a
    CUDA device without a card, and the check must raise before any
    tensor is made on it."""
    import threading

    from ray_tpu_torch.llm import engine as te
    monkeypatch.setattr(te, "resolve_device", torch.device)
    threads = threading.active_count()
    with pytest.raises(ValueError, match="head dim 8"):
        LLMServer()
    with pytest.raises(ValueError, match="page size 24"):
        TEngine(tl.LlamaConfig.tiny(dim=1024, n_heads=16, n_kv_heads=8),
                page_size=24)
    with pytest.raises(TypeError, match="q dtype"):
        TEngine(tl.LlamaConfig.llama3_8b(dtype=torch.float16))
    assert threading.active_count() == threads
