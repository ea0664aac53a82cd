"""The port's block autotuning against the JAX package's, on the CPU.

Twins of ``tests/test_ops.py::TestBlockAutotune``, each run through both
packages: on the CPU the port's candidates, heuristic pick, measured pick
(a fake timer), ``None`` for lengths no block divides and the cache equal
the JAX package's, and ``blk_q=None, blk_k=None`` reaches the plain
forward with the cached blocks as it reaches the Pallas kernel. Then the
port's deliberate differences: the tuned entry is a ``FlashTiles`` (a
pair per kernel, the three equal on the CPU); on the card the candidates
are each kernel's built variants that fit its shared memory (a function of
the device kind, checked here without a card), timed one kernel at a
time; a failing candidate raises; and Llama's flash path,
``flash_attention_sharded`` and the fused ring's ``fused_blocks`` read the
cache. Shapes stay tiny (L <= 128, head dim <= 64).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import flash_attention as tfa

# the modules (both packages re-export functions of the same names)
jfa = importlib.import_module("ray_tpu.ops.flash_attention")
tring = importlib.import_module("ray_tpu_torch.parallel.ring_attention")

torch.set_num_threads(1)

H100 = "NVIDIA H100 80GB HBM3"
F32_TOL = 2e-5   # fp32 on both sides: the order of sums only
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _clean_caches():
    jfa.clear_block_cache()
    tfa.clear_block_cache()
    yield
    jfa.clear_block_cache()
    tfa.clear_block_cache()


def test_pick_block_floor():
    for fa in (jfa, tfa):
        assert fa.pick_block(256) == 256
        assert fa.pick_block(20) is None        # no divisor >= 8
        assert fa.pick_block(4) is None         # below the floor
        assert fa.pick_block(4, min_block=1) == 4


@pytest.mark.parametrize("Lq,Lk,D,dtype", [
    (2048, 2048, 64, "bfloat16"), (2048, 2048, 128, "bfloat16"),
    (128, 64, 32, "float32"), (96, 200, 64, "float32"),
    (1000, 24, 128, "bfloat16"), (4096, 512, 1024, "float32")])
def test_candidates_match_jax_pair_for_pair(Lq, Lk, D, dtype):
    jdt, tdt = DTYPES[dtype]
    want = jfa.block_candidates(Lq, Lk, D, jdt)
    got = tfa.block_candidates(Lq, Lk, D, tdt)
    assert got == want
    if (Lq, Lk, D) == (2048, 2048, 64):
        assert got[0] == (256, 256)
    for bq, bk in got:
        assert bq >= 8 and bk >= 8 and Lq % bq == 0 and Lk % bk == 0


def test_autotune_measures_and_caches():
    """A fake timer makes (64, 32) win in both packages; the second call
    is a cache hit that times nothing."""
    calls = {"jax": [], "torch": []}
    picks = {}
    for name, fa, dtype, kw in (("jax", jfa, jnp.float32, {}),
                                ("torch", tfa, torch.float32,
                                 {"device": "cpu"})):
        def fake_timer(Lq, Lk, D, dt, bq, bk, _calls=calls[name], **kw):
            _calls.append((bq, bk))
            return abs(bq - 64) + abs(bk - 32)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fa, "_time_blocks", fake_timer)
            picks[name] = fa.autotune_blocks(128, 64, 32, dtype,
                                             measure=True, **kw)
            n = len(calls[name])
            assert fa.autotune_blocks(128, 64, 32, dtype, measure=True,
                                      **kw) == picks[name]
            assert len(calls[name]) == n, "the second call must hit"
    assert picks["jax"] == (64, 32)
    assert picks["torch"] == tfa.FlashTiles.uniform((64, 32))
    assert calls["torch"] == calls["jax"]   # the same candidates, in order
    assert jfa.get_tuned_blocks(128, 64, 32, jnp.float32) == (64, 32)
    assert tfa.get_tuned_blocks(128, 64, 32, torch.float32, "cpu") == \
        tfa.FlashTiles.uniform((64, 32))


@pytest.mark.parametrize("measure", [False, None])
def test_autotune_heuristic_without_measure(measure):
    """measure False, and None on the CPU (where no kernel runs), pick the
    heuristic's first candidate without timing."""
    def no_timer(*a, **k):
        raise AssertionError("timed on the CPU")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfa, "_time_blocks", no_timer)
        mp.setattr(tfa, "_time_blocks", no_timer)
        j = jfa.autotune_blocks(2048, 2048, 64, jnp.bfloat16,
                                measure=measure)
        t = tfa.autotune_blocks(2048, 2048, 64, torch.bfloat16,
                                measure=measure, device="cpu")
    assert j == (256, 256)
    assert t == tfa.FlashTiles.uniform(j)
    assert tfa.kernels_supported("cpu") is jfa.kernels_supported() \
        is False


def test_autotune_indivisible_returns_none():
    assert jfa.autotune_blocks(20, 20, 64, jnp.float32,
                               measure=False) is None
    assert tfa.autotune_blocks(20, 20, 64, torch.float32,
                               measure=False, device="cpu") is None
    assert tfa.get_tuned_blocks(20, 20, 64, torch.float32, "cpu") is None


def test_cache_keys_and_clear_match_jax():
    assert tfa._block_cache_key(64, 48, 32, torch.float32, "cpu") == \
        jfa._block_cache_key(64, 48, 32, jnp.float32)
    tfa.autotune_blocks(64, None, 32, torch.float32, device="cpu")
    jfa.autotune_blocks(64, None, 32, jnp.float32)
    assert tfa.get_tuned_blocks(64, 64, 32, torch.float32, "cpu").fwd == \
        jfa.get_tuned_blocks(64, 64, 32, jnp.float32)
    tfa.clear_block_cache()
    jfa.clear_block_cache()
    assert tfa.get_tuned_blocks(64, 64, 32, torch.float32, "cpu") is None
    assert jfa.get_tuned_blocks(64, 64, 32, jnp.float32) is None


def _spy(monkeypatch, fa, name, seen):
    """Record the blocks (arguments 5 and 6) of each call of ``fa.name``:
    the JAX ``_fwd_call`` and the port's ``_fwd_reference`` alike."""
    real = getattr(fa, name)

    def spy(*args):
        seen.append(args[5:7])
        return real(*args)

    monkeypatch.setattr(fa, name, spy)


def assert_close(got, want, dtype, kind="out"):
    """``tests/test_torch_flash_attention.py``'s limits: fp32 within
    F32_TOL; bf16 per row within 2^-7 (outputs) or 2^-6 (gradients) of
    the row's largest |want|, plus 1e-5."""
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        return
    rtol = 2.0 ** -7 if kind == "out" else 2.0 ** -6
    err = np.abs(got - want).max(-1)
    assert (err <= rtol * np.abs(want).max(-1) + 1e-5).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_uses_tuned_blocks(monkeypatch, dtype):
    """blk None routes through the cache in both packages: the Pallas
    forward (interpret mode) and the port's plain forward and backward
    see the planted (32, 32); the outputs agree within
    ``tests/test_torch_flash_attention.py``'s limits, and the port's
    gradients equal those of an explicit (32, 32)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    q, k, v, go = (rng.standard_normal((1, 64, 2, 32)).astype(np.float32)
                   for _ in range(4))
    jfa._BLOCK_CACHE[jfa._block_cache_key(64, 64, 32, jdt)] = (32, 32)
    tfa._BLOCK_CACHE[tfa._block_cache_key(64, 64, 32, tdt, "cpu")] = \
        tfa.FlashTiles.uniform((32, 32))
    jseen, tseen, bseen = [], [], []
    _spy(monkeypatch, jfa, "_fwd_call", jseen)
    jo = jfa.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                             blk_q=None, blk_k=None, interpret=True)
    grads = []
    for blocks in ((None, None), (32, 32)):
        _spy(monkeypatch, tfa, "_fwd_reference", tseen)
        real_bwd = tfa._bwd_reference

        def bwd_spy(*args, _real=real_bwd):
            bseen.append(args[8:10])
            return _real(*args)

        monkeypatch.setattr(tfa, "_bwd_reference", bwd_spy)
        tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                      for a in (q, k, v))
        to = tfa.flash_attention(tq, tk, tv, True, None, *blocks)
        (to.float() * torch.from_numpy(go)).sum().backward()
        grads.append((to, tq.grad, tk.grad, tv.grad))
        monkeypatch.undo()
    assert jseen == [(32, 32)]
    assert tseen == [(32, 32)] * 2 and bseen == [(32, 32)] * 2
    assert_close(grads[0][0], jo, dtype)
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_without_an_entry_the_blocks_are_256():
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, tfa, "_fwd_reference", seen)
        q = torch.zeros(1, 512, 1, 16)
        tfa.flash_attention(q, q, q, blk_q=None, blk_k=None)
    assert seen == [(256, 256)]


# ------------------------------------------------- deliberate differences


def test_card_candidates_come_from_the_variant_table():
    """Each kernel's built tiles whose shared memory (``_est_smem_bytes``)
    fits the kind's opt-in limit, the default first: on an H100 both
    variants of each Hopper kernel at bf16 / head dim 128, one tile for
    the first designs, none where no variant is built or no sm_90a kernel
    runs. A smaller limit drops what no longer fits."""
    sm90 = tfa.kernel_candidates(128, torch.bfloat16, H100)
    assert sm90 == {k: list(v) for k, v in
                    tfa.KERNEL_TILES[(torch.bfloat16, 128)].items()}
    assert sm90 == {"fwd": [(128, 128), (128, 64)],
                    "dq": [(128, 64), (128, 128)],
                    "dkv": [(64, 128), (128, 128)]}
    assert tfa.default_tiles(torch.bfloat16, 128) == tfa.FlashTiles(
        (128, 128), (128, 64), (64, 128))
    assert tfa.kernel_candidates(64, torch.float32, "NVIDIA H200") == \
        dict.fromkeys(tfa.FLASH_KERNELS, [(32, 32)])
    assert tfa.kernel_candidates(64, torch.bfloat16, H100) == \
        dict.fromkeys(tfa.FLASH_KERNELS, [(64, 64)])
    assert tfa.kernel_candidates(32, torch.bfloat16, H100) == \
        dict.fromkeys(tfa.FLASH_KERNELS, [])
    assert tfa.kernel_candidates(128, torch.bfloat16,
                                 "NVIDIA A100-SXM4-80GB") == \
        dict.fromkeys(tfa.FLASH_KERNELS, [])
    assert tfa.smem_limit(H100) == 232_448 and tfa.smem_limit("cpu") == 0
    smem = {(k, t): tfa._est_smem_bytes(k, *t, 128, torch.bfloat16)
            for k, ts in sm90.items() for t in ts}
    # the kernels' own layouts (kSmem in csrc/flash_attention_*.cu)
    assert smem == {("fwd", (128, 128)): 164_936,
                    ("fwd", (128, 64)): 165_000,
                    ("dq", (128, 64)): 198_792,
                    ("dq", (128, 128)): 198_728,
                    ("dkv", (64, 128)): 134_184,
                    ("dkv", (128, 128)): 199_720}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfa, "HOPPER_SMEM_OPTIN", 199_000)
        assert tfa.kernel_candidates(128, torch.bfloat16, H100)["dkv"] == \
            [(64, 128)]
    with pytest.raises(ValueError, match="not built"):
        tfa._est_smem_bytes("fwd", 64, 64, 128, torch.bfloat16)


@pytest.fixture
def on_a_card_kind(monkeypatch):
    """The platform reads as an H100 (no card touched): the tuner takes
    the card's candidates."""
    monkeypatch.setattr(tfa, "_platform", lambda device=None: H100)


def test_autotune_on_the_card_times_each_kernel_alone(on_a_card_kind,
                                                      monkeypatch):
    """Each kernel's two variants timed on their own (six calls, not
    eight), each kernel's fastest cached, the second call a hit."""
    calls = []
    fastest = {"fwd": (128, 64), "dq": (128, 64), "dkv": (128, 128)}

    def fake_timer(Lq, Lk, D, dtype, bq, bk, *, kernel, device=None):
        calls.append((kernel, (bq, bk)))
        return 1.0 if (bq, bk) == fastest[kernel] else 2.0

    monkeypatch.setattr(tfa, "_time_blocks", fake_timer)
    got = tfa.autotune_blocks(2048, 2048, 128, torch.bfloat16, measure=True)
    assert got == tfa.FlashTiles(**fastest)
    assert sorted(calls) == sorted(
        (k, t) for k, ts in tfa.KERNEL_TILES[(torch.bfloat16, 128)].items()
        for t in ts)
    assert tfa.last_sweep["dkv"] == {(64, 128): 2.0, (128, 128): 1.0}
    assert tfa.autotune_blocks(2048, 2048, 128, torch.bfloat16,
                               measure=True) == got and len(calls) == 6
    assert tfa.get_tuned_blocks(2048, 2048, 128, torch.bfloat16) == got
    # one tile per kernel (fp32): returned without timing
    assert tfa.autotune_blocks(256, 256, 64, torch.float32,
                               measure=True) == \
        tfa.FlashTiles.uniform((32, 32)) and len(calls) == 6
    # a head dim no kernel is built for: None, as for indivisible lengths
    assert tfa.autotune_blocks(256, 256, 32, torch.bfloat16,
                               measure=True) is None


@pytest.mark.parametrize("platform", ["cpu", "card"])
def test_a_failing_candidate_raises(monkeypatch, platform):
    """No candidate failure turns into a loss: the timer's error leaves
    ``autotune_blocks`` and nothing is cached."""
    device = "cpu"
    if platform == "card":
        monkeypatch.setattr(tfa, "_platform", lambda device=None: H100)
        device = None

    def broken(*a, **k):
        raise RuntimeError("flash_attention_fwd launch failed")

    monkeypatch.setattr(tfa, "_time_blocks", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        tfa.autotune_blocks(2048, 2048, 128, torch.bfloat16, measure=True,
                            device=device)
    assert tfa.get_tuned_blocks(2048, 2048, 128, torch.bfloat16,
                                device) is None


def test_measuring_without_a_card_raises():
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        tfa.autotune_blocks(128, 128, 32, torch.float32, measure=True,
                            device="cpu")
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        tfa._time_blocks(128, 128, 128, torch.bfloat16, 128, 128,
                         kernel="fwd", device="cpu")


@pytest.mark.parametrize("call", [
    lambda: tfa._device(),
    lambda: tfa._platform(),
    lambda: tfa.kernels_supported(),
    lambda: tfa.get_tuned_blocks(64, 64, 32, torch.float32),
    lambda: tfa.autotune_blocks(64, 64, 32, torch.float32),
], ids=["_device", "_platform", "kernels_supported", "get_tuned_blocks",
        "autotune_blocks"])
def test_no_device_without_a_card_raises(call):
    """device None is the card: without one it raises with
    ``resolve_device``'s message (it returned the CPU before, and
    ``autotune_blocks`` then cached the CPU's pick); nothing is cached."""
    with pytest.raises(RuntimeError, match="is False; pass device='cpu'"):
        call()
    assert not tfa._BLOCK_CACHE


def test_an_unbuilt_tile_raises_before_any_launch():
    q = torch.zeros(2, 128, 128, dtype=torch.bfloat16)
    before = dict(tfa.launch_counts)
    with pytest.raises(ValueError, match="not built"):
        tfa._fwd_cuda(q, q, q, True, 0.1, (64, 64))
    lse = torch.zeros(2, 128)
    with pytest.raises(ValueError, match="not built"):
        tfa._bwd_cuda(q, q, q, lse, q, lse, True, 0.1, tfa.FlashTiles(
            (128, 128), (128, 64), (128, 64)))
    assert tfa.launch_counts == before


def test_each_kernel_blocks_its_plain_version_by_its_own_pair():
    """A record with a pair per kernel: on the CPU the forward blocks by
    ``fwd``, dq by ``dq`` and dk/dv by ``dkv``, each exactly the plain
    version at those blocks."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 64, 16))
                                    .astype(np.float32)) for _ in range(4))
    tiles = tfa.FlashTiles((32, 16), (16, 32), (64, 8))
    o, lse = tfa._fwd_call(q, k, v, True, 0.25, tiles=tiles)
    want_o, want_lse = tfa._fwd_reference(q, k, v, True, 0.25, 32, 16)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    got = tfa._bwd_call(q, k, v, o, lse, do, True, 0.25, tiles=tiles)
    delta = (do * o).sum(-1)
    dq = tfa._bwd_reference(q, k, v, lse, do, delta, True, 0.25, 16, 32)[0]
    _, dk, dv = tfa._bwd_reference(q, k, v, lse, do, delta, True, 0.25, 64,
                                   8)
    for g, w in zip(got, (dq, dk, dv)):
        assert torch.equal(g, w)


def test_llama_flash_path_reads_the_cache(monkeypatch):
    """Llama's flash attention passes blk None (the JAX package's
    ``llama.py:275``): a planted entry at its (L, head dim, dtype) blocks
    every layer's plain forward; without one, 256 (here L, which it
    exceeds)."""
    cfg = tllama.LlamaConfig.tiny(n_layers=2, attention="flash",
                                  dtype=torch.float32)
    params = tllama.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(0))
    seen = []
    _spy(monkeypatch, tfa, "_fwd_reference", seen)
    with torch.no_grad():
        plain = tllama.forward(params, tokens, cfg)
        tfa._BLOCK_CACHE[tfa._block_cache_key(
            32, 32, cfg.head_dim, torch.float32, "cpu")] = \
            tfa.FlashTiles.uniform((16, 8))
        tuned = tllama.forward(params, tokens, cfg)
    assert seen == [(32, 32)] * 2 + [(16, 8)] * 2
    torch.testing.assert_close(tuned, plain, rtol=F32_TOL, atol=F32_TOL)


def test_flash_attention_sharded_reads_the_cache(monkeypatch):
    seen = []
    _spy(monkeypatch, tfa, "_fwd_reference", seen)
    q = torch.zeros(2, 64, 2, 16)
    tfa._BLOCK_CACHE[tfa._block_cache_key(64, 64, 16, torch.float32,
                                          "cpu")] = \
        tfa.FlashTiles.uniform((16, 32))
    tfa.flash_attention_sharded(q, q, q, None)
    assert seen == [(16, 32)]


def test_fused_blocks_read_the_cache(monkeypatch):
    """The tuned entry wins in ``fused_blocks`` (the JAX package's
    ``_resolve_fused_blocks``) and reaches the rotation's flash block;
    without one, the divisor heuristic of interpret mode."""
    assert tring.fused_blocks(24, 48, 16, torch.float32, "cpu") == (8, 16)
    planted = tfa.FlashTiles.uniform((8, 12))
    tfa._BLOCK_CACHE[tfa._block_cache_key(24, 48, 16, torch.float32,
                                          "cpu")] = \
        planted
    assert tring.fused_blocks(24, 48, 16, torch.float32, "cpu") is planted
    seen = []
    _spy(monkeypatch, tfa, "_fwd_reference", seen)
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((1, 24, 2, 16))
                         .astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 48, 2, 16))
                          .astype(np.float32))
    o = torch.zeros(1, 24, 2, 16)
    lse = torch.full((1, 2, 24), float("-inf"))
    tring.ring_rotation(q, kv, kv, o, lse, 0, 1, True, 0.25)
    assert seen == [(8, 12)]


def test_phase_7b_on_the_cpu():
    """chip_smoke.py's 7b rehearsed at a tiny width: phase 7's run, the
    sweep (on the CPU the heuristic's pick, nothing timed), then phase 7's
    step with the picked blocks (equal to the untuned run: the same
    blocks) and with other blocks per kernel (within TUNED_LOSS_RTOL);
    the cache is left as the sweep filled it, so the test empties it."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    cpu = torch.device("cpu")
    config = dict(chip_smoke.TRAIN_CONFIG, vocab_size=256, dim=128,
                  n_layers=1, n_heads=1, n_kv_heads=1, ffn_dim=256)
    batch = (1, 64)
    chip_smoke.TRAIN_RUNS.clear()
    chip_smoke.phase_train(cpu, config, batch, profile=False)
    tuned = chip_smoke.phase_autotune(cpu, (1, 1, 64, 128))
    assert tuned == tfa.FlashTiles.uniform((64, 64))
    chip_smoke.phase_train_tiles(cpu, tuned, "tuned", config, batch)
    assert chip_smoke.TRAIN_RUNS["tuned"]["losses"] == \
        chip_smoke.TRAIN_RUNS["adafactor"]["losses"]
    chip_smoke.phase_train_tiles(
        cpu, tfa.FlashTiles((64, 32), (32, 64), (16, 64)), "other blocks",
        config, batch)
