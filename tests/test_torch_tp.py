"""The port's tensor-parallel engine against the JAX package's, on the CPU.

The JAX tp engine shards over 2 or 4 of the 8 virtual CPU devices
(``shard_map``, the gather reference per shard); the port's drives 2 or 4
shards on the CPU from one process (``llm/tp.py``, the plain attention per
shard). Parameters are the JAX package's (``convert``), the cases
tests/test_llm.py's tp cases: greedy streams single and batched, chunked
prefill, a prefix hit and COW, int8 KV, and the errors. fp32 on both
sides: streams must be equal token for token (the row-split sums change
the last bits of the residual, never an argmax here); int8 is compared
margin-aware, as tests/test_torch_llm.py compares it at tp 1.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from ray_tpu.llm.engine import InferenceEngine as JEngine
from ray_tpu.models import llama as jl
from ray_tpu_torch import convert
from ray_tpu_torch.llm import tp as ttp
from ray_tpu_torch.llm.engine import InferenceEngine as TEngine
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.llama import tree_leaves

torch.set_num_threads(1)

JCFG = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
V = JCFG.vocab_size
KW = dict(page_size=8, total_pages=64, max_batch=4, max_seq_len=128,
          decode_chunk=4)
# int8 round-trip noise on this model's logits (tests/test_torch_llm.py)
INT8_LOGIT_NOISE = 0.05


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(7))
    return jp, convert.from_jax(jp, device="cpu")


def _prompt(mult, add, n):
    return [(mult * i + add) % V for i in range(n)]


def _run_batch(eng, prompts, n):
    rids = [eng.add_request(p, n) for p in prompts]
    done = {}
    for _ in range(200):
        done.update(eng.step())
        if len(done) == len(rids):
            break
    return [done[r] for r in rids]


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_engine_matches_jax_tp_and_tp1(params, tp):
    """tp 2 and 4: the single-prompt and the batched ragged prefill give
    the JAX tp engine's streams and the port's tp=1 streams, with the
    JAX engine's dispatch counts; each shard holds Hkv/tp heads in
    contiguous tensors of its own, and the engine dispatched at most 3
    step programs."""
    jp, tp_params = params
    je = JEngine(JCFG, jp, tp=tp, **KW)
    te = TEngine(TCFG, tp_params, tp=tp, device="cpu", **KW)
    t1 = TEngine(TCFG, tp_params, device="cpu", **KW)
    assert te.tp == tp and len(te.kv) == tp and len(te.params) == tp
    for pool in te.kv:
        assert pool["k"].shape[2] == TCFG.n_kv_heads // tp
        assert all(t.is_contiguous() for t in pool.values())
    for shard in te.params:
        assert shard["layers"]["wq"].shape[-1] == TCFG.dim // tp
        assert shard["layers"]["w_down"].shape[1] == TCFG.ffn_dim // tp
        assert all(t.is_contiguous() for t in shard["layers"].values())
    prompt = [5, 17, 42, 9, 100, 3, 77]
    want = je.generate(prompt, max_new_tokens=10)
    assert te.generate(prompt, max_new_tokens=10) == want
    assert t1.generate(prompt, max_new_tokens=10) == want
    prompts = [[11, 22, 33], [101, 5, 9], [60, 61, 62, 63, 64]]
    want = _run_batch(je, prompts, 6)
    assert _run_batch(te, prompts, 6) == want
    assert _run_batch(t1, prompts, 6) == want
    for key in ("ragged_dispatches", "decode_dispatches"):
        assert te.stats[key] == je.stats[key], key
    assert te.compiled_step_programs() <= 3


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_chunked_prefill_prefix_and_cow(params, tp):
    """Chunked cold prefill (3 ragged dispatches), a prefix-cache hit of
    16 tokens and an exact-page-multiple prompt's COW copy on the shards:
    the JAX tp engine's streams and counters."""
    jp, tp_params = params
    kw = dict(KW, max_batch=2, prefill_chunk=8)
    engines = [JEngine(JCFG, jp, tp=tp, **kw),
               TEngine(TCFG, tp_params, tp=tp, device="cpu", **kw)]
    prompt = _prompt(5, 2, 20)
    outs = []
    for eng in engines:
        cold = eng.generate(prompt, max_new_tokens=6)
        dispatches = eng.stats["ragged_dispatches"]
        rid = eng.add_request(prompt, 6)
        hit = _run_batch_rid(eng, rid)
        cached = eng.cached_tokens(rid)
        cow = eng.generate(prompt[:16], max_new_tokens=4)
        outs.append((cold, dispatches, hit, cached, cow,
                     eng.stats["cow_copies"]))
    assert outs[1] == outs[0]
    assert outs[0][1] == 3 and outs[0][3] == 16 and outs[0][5] == 1


def _run_batch_rid(eng, rid):
    done = {}
    for _ in range(100):
        done.update(eng.step())
        if rid in done:
            return done[rid]
    raise AssertionError("request did not finish")


def _top2_margin(jparams, toks):
    import numpy as np
    logits = np.asarray(jl.forward(jparams, jnp.asarray([toks]), JCFG))
    top = np.sort(logits[0, -1])[-2:]
    return float(top[1] - top[0])


def test_tp_int8_engine_matches_jax_int8_tp_margin_aware():
    """int8 KV at tp 2 (pools and scales split on the kv-head axis)
    against the JAX int8 tp engine: tokens compared while the fp
    oracle's top-2 margin exceeds the int8 noise, as at tp 1."""
    jp = jl.init_params(JCFG, jax.random.PRNGKey(1))   # has a near-tie
    kw = dict(KW, prefill_chunk=8, kv_dtype="int8")
    je = JEngine(JCFG, jp, tp=2, **kw)
    te = TEngine(TCFG, convert.from_jax(jp, device="cpu"), tp=2,
                 device="cpu", **kw)
    for pool in te.kv:
        assert set(pool) == {"k", "v", "k_scale", "v_scale"}
        assert pool["k"].dtype == torch.int8
        assert pool["k_scale"].shape[2] == TCFG.n_kv_heads // 2
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


@pytest.mark.parametrize("kw,tp", [({}, 3), ({}, 1), ({}, 8),
                                   ({"n_heads": 6, "n_kv_heads": 2}, 4),
                                   ({}, 2)])
def test_validate_tp_matches_jax(kw, tp):
    from ray_tpu.llm.tp import validate_tp as jvalidate

    def outcome(fn, cfg):
        try:
            fn(cfg, tp)
            return "ok"
        except ValueError as e:
            return str(e)

    assert outcome(ttp.validate_tp, tl.LlamaConfig.tiny(**kw)) == \
        outcome(jvalidate, jl.LlamaConfig.tiny(**kw))


def test_too_few_devices_raises_as_jax():
    """More shards than devices: the JAX engine's message, from the
    device list, before the split is validated."""
    with pytest.raises(ValueError) as jerr:
        JEngine(JCFG, tp=64)
    with pytest.raises(ValueError) as terr:
        TEngine(TCFG, tp=64, devices=["cpu"] * 8, **KW)
    assert str(terr.value) == str(jerr.value) == \
        "tp=64 needs 64 devices, have 8"
    with pytest.raises(ValueError, match="must divide"):
        TEngine(TCFG, tp=3, device="cpu", **KW)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            TEngine(TCFG, tp=2, **KW)


def test_sum_shards_adds_per_device_in_order():
    """Shards on one device share one sum; the result equals the sum in
    shard order."""
    parts = [torch.full((2, 3), float(i + 1)) for i in range(4)]
    out = ttp.sum_shards(parts)
    assert all(o is out[0] for o in out)
    assert torch.equal(out[0], torch.full((2, 3), 10.0))


def test_shard_params_round_trip(params):
    """``gather_params`` inverts ``shard_params``; the replicated leaves
    are one tensor per device, shared by its shards."""
    _, tp_params = params
    fns = ttp.TPEngineFns(TCFG, [torch.device("cpu")] * 2, decode_chunk=4,
                          max_q_len=8, decode_rows=4)
    shards = fns.shard_params(tree_leaves(tp_params), torch.float32)
    assert shards[0]["embed"] is shards[1]["embed"]
    back = fns.gather_params(shards)
    for name, leaf in tp_params["layers"].items():
        assert torch.equal(back["layers"][name], leaf), name
    assert torch.equal(back["embed"], tp_params["embed"])


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_tp_engine_draws_its_shards_as_tp1_draws_the_model(param_dtype):
    """With no parameters given, the tp engine cuts each drawn matrix into
    its shards as it is drawn: the shards gathered are tp=1's parameters
    to the bit (the same draws, cast to the compute dtype once), the
    given tree of a second engine is left as it was, and that engine's
    shards hold storage of their own."""
    cfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32,
                              param_dtype=param_dtype)
    one = TEngine(cfg, device="cpu", seed=3, **KW)
    two = TEngine(cfg, tp=2, device="cpu", seed=3, **KW)
    whole = two._fns.gather_params(two.params)
    for (path, _, got), (_, _, want) in zip(tree_leaves(whole),
                                            tree_leaves(one.params)):
        assert all(torch.equal(a, b) for a, b in zip(got, want)), path
    given = tl.init_params(cfg, 3, "cpu")
    before = {path: torch.stack(list(parts)).clone()
              for path, _, parts in tree_leaves(given)}
    three = TEngine(cfg, given, tp=2, device="cpu", **KW)
    ptrs = {t.untyped_storage().data_ptr()
            for _, _, parts in tree_leaves(given) for t in parts}
    for path, _, parts in tree_leaves(given):
        assert torch.equal(torch.stack(list(parts)), before[path]), path
    for shard in three.params:
        for _, _, parts in tree_leaves(shard):
            assert all(t.untyped_storage().data_ptr() not in ptrs
                       for t in parts)


@pytest.mark.parametrize("quantized", [False, True])
def test_specs_match_jax(quantized):
    """``tp_param_specs`` and ``kv_specs`` name the JAX package's axes, and
    each shard's pool is the kv-head split ``kv_specs`` says."""
    from ray_tpu.llm import tp as jtp

    def flat(tree):
        return {k: (flat(v) if isinstance(v, dict) else tuple(v))
                for k, v in tree.items()}

    assert flat(ttp.tp_param_specs(TCFG)) == flat(jtp.tp_param_specs(JCFG))
    assert flat(ttp.kv_specs(quantized)) == flat(jtp.kv_specs(quantized))
    from ray_tpu_torch.llm.cache import make_kv_cache
    whole = make_kv_cache(TCFG, 8, 4, kv_dtype="int8" if quantized else None,
                          device="cpu")
    shards = make_kv_cache(TCFG, 8, 4, kv_dtype="int8" if quantized
                           else None, devices=["cpu"] * 2)
    for name, spec in ttp.kv_specs(quantized).items():
        dim = list(spec).index("tp")
        for s in shards:
            want = list(whole[name].shape)
            want[dim] //= 2
            assert list(s[name].shape) == want and s[name].is_contiguous()
