"""The port's Mixtral (``ray_tpu_torch.models.mixtral``) against the JAX
package's (``ray_tpu.models.mixtral``), on the CPU.

Parameters are made by the JAX package and carried over with
``ray_tpu_torch.convert``; tokens come from a numpy seed. In fp32 both
sides differ only in the order of fp32 sums: logits, aux and loss agree to
1e-5, gradients to 1e-5 of their leaf's largest value (plus 1e-7), and the
routing indices are equal. In bf16 the tokens whose top-2 choice lies
within rounding noise of the 3rd are left out of the comparison
(``BF16_MARGIN``, as in tests/test_torch_moe.py). Then the remat policies
(what "selective" saves, counted op by op), the counts of parameters and
FLOPs, the mesh-only paths, the train step with Adafactor against
``optax.adafactor``, parameter conversion, and chip_smoke.py's Mixtral
phases at a tiny size.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from ray_tpu.models import mixtral as jm
from ray_tpu.train.train_step import make_train_step as jax_train_step
from ray_tpu_torch import convert
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import mixtral as tm
from ray_tpu_torch.parallel import moe as tmoe
from ray_tpu_torch.train import Adafactor, make_train_step, param_leaves
from test_torch_adafactor import (PARAM_RTOL, STATE_RTOL,
                                  _assert_state_close,
                                  load_adafactor_state)

torch.set_num_threads(1)

LOSS_TOL = 1e-5
GRAD_RTOL = 1e-5
# bf16 routing: see tests/test_torch_moe.py. bf16 layer outputs and
# logits per token against the row's largest value: the experts' limit
# (2^-5, tests/test_torch_moe.py), which the attention block's few bf16
# roundings (2^-8 each) stay inside (measured: 0.0108 of the row at most)
BF16_MARGIN = 2.0 ** -5
BF16_ROW_RTOL = 2.0 ** -5
ROOT = Path(__file__).resolve().parents[1]


def _configs(**kw):
    return (jm.MixtralConfig.tiny(dtype=jnp.float32, **kw),
            tm.MixtralConfig.tiny(dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def setup():
    jcfg, _ = _configs()
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16))
    return jparams, tokens


def _torch_params(jparams, requires_grad=True):
    params = convert.from_jax(jparams, device="cpu")
    for leaf in param_leaves(params):
        leaf.requires_grad_(requires_grad)
    return params


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_np(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().float().numpy()]
    return [np.asarray(tree, np.float32)]


def assert_trees_close(got, want, rtol=GRAD_RTOL):
    got, want = _leaves_np(got), _leaves_np(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rtol * np.abs(w).max() + 1e-7)


def _loss_and_grads(tcfg, jparams, tokens):
    params = _torch_params(jparams)
    loss = tm.loss_fn(params, torch.from_numpy(tokens), tcfg)
    loss.backward()
    grads = {k: v.grad if isinstance(v, torch.Tensor) else
             {n: t.grad for n, t in v.items()} for k, v in params.items()}
    return float(loss.detach()), grads


@pytest.mark.parametrize("policy", ["full", "selective"])
def test_logits_aux_loss_and_grads_match_jax(setup, policy):
    jparams, tokens = setup
    jcfg, tcfg = _configs(remat_policy=policy)
    jlogits, jaux = jm.forward(jparams, jnp.asarray(tokens), jcfg,
                               return_aux=True)
    jloss, jgrads = jax.value_and_grad(functools.partial(
        jm.loss_fn, cfg=jcfg))(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        logits, aux = tm.forward(_torch_params(jparams, False),
                                 torch.from_numpy(tokens), tcfg,
                                 return_aux=True)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=LOSS_TOL)
    assert float(aux) == pytest.approx(float(jaux), abs=LOSS_TOL)
    loss, grads = _loss_and_grads(tcfg, jparams, tokens)
    assert loss == pytest.approx(float(jloss), abs=LOSS_TOL)
    assert_trees_close(grads, jgrads)


def _layer_inputs(jparams, tokens, jcfg):
    """The embedding and each JAX layer's parameters and positions."""
    x = jparams["embed"].astype(jcfg.dtype)[jnp.asarray(tokens)]
    layers = [jax.tree.map(lambda a: a[i], jparams["layers"])
              for i in range(jcfg.n_layers)]
    return x, layers, jnp.arange(tokens.shape[1])


def _record(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append(out)
        return out

    monkeypatch.setattr(module, name, wrapper)
    return calls


def test_routing_and_each_layer_match_jax(setup, monkeypatch):
    """Layer by layer from the same input (JAX's output of the layer
    before): equal routing indices, the layer's output and its aux term
    in fp32."""
    jparams, tokens = setup
    jcfg, tcfg = _configs(remat=False)
    jroutes = _record(monkeypatch, jm, "_routing")
    troutes = _record(monkeypatch, tm, "_top_k")
    x, layers, positions = _layer_inputs(jparams, tokens, jcfg)
    for i, lp in enumerate(layers):
        jx, jaux = jm._layer(lp, x, jcfg, positions, None)
        tx, taux = tm._layer(convert.from_jax(lp, device="cpu"),
                             convert.from_jax(x, device="cpu"), tcfg,
                             torch.arange(tokens.shape[1]))
        np.testing.assert_array_equal(troutes[i][0].numpy(),
                                      np.asarray(jroutes[i][0]))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                                   atol=LOSS_TOL)
        assert float(taux) == pytest.approx(float(jaux), abs=LOSS_TOL)
        x = jx
    assert len(troutes) == jcfg.n_layers


def test_bf16_forward_matches_jax_where_routing_is_clear(setup,
                                                         monkeypatch):
    """bf16, layer by layer from the same input: tokens whose 2nd/3rd
    router probability gap (fp32 softmax of the port's bf16 logits)
    exceeds BF16_MARGIN route alike and agree within BF16_ROW_RTOL of the
    row's largest value. Then the whole bf16 forward: the logits of each
    position whose own and earlier tokens were all clear in every layer
    agree within the same row limit."""
    jparams, tokens = setup
    tokens = np.random.default_rng(7).integers(0, 256, (4, 32))
    kw = dict(remat=False)
    jcfg = jm.MixtralConfig.tiny(**kw)              # bf16 compute
    tcfg = tm.MixtralConfig.tiny(**kw)
    assert jcfg.dtype == jnp.bfloat16 and tcfg.dtype == torch.bfloat16
    probs = _record(monkeypatch, tm, "_router_probs")
    jroutes = _record(monkeypatch, jm, "_routing")
    troutes = _record(monkeypatch, tm, "_top_k")
    x, layers, positions = _layer_inputs(jparams, tokens, jcfg)
    clear_rows = []
    for i, lp in enumerate(layers):
        jx, _ = jm._layer(lp, x, jcfg, positions, None)
        tx, _ = tm._layer(convert.from_jax(lp, device="cpu"),
                          convert.from_jax(x, device="cpu"), tcfg,
                          torch.arange(tokens.shape[1]))
        top3 = probs[-1].topk(3, dim=-1).values
        clear = ((top3[:, 1] - top3[:, 2]) > BF16_MARGIN).numpy()
        np.testing.assert_array_equal(
            np.sort(troutes[-1][0].numpy(), -1)[clear],
            np.sort(np.asarray(jroutes[-1][0]), -1)[clear])
        want = np.asarray(jx.astype(jnp.float32)).reshape(-1, jcfg.dim)
        got = tx.float().numpy().reshape(-1, jcfg.dim)
        ratio = np.abs(got - want).max(-1) / (
            BF16_ROW_RTOL * np.abs(want).max(-1))
        assert clear.sum() >= len(clear) // 2, clear.sum()
        assert ratio[clear].max() <= 1, (i, ratio[clear].max())
        clear_rows.append(clear.reshape(tokens.shape))
        x = jx
    jlogits = np.asarray(jm.forward(jparams, jnp.asarray(tokens), jcfg))
    with torch.no_grad():
        logits = tm.forward(convert.from_jax(jparams, device="cpu"),
                            torch.from_numpy(tokens), tcfg).numpy()
    # a position sees every earlier token of its row through attention
    held = np.cumprod(np.logical_and.reduce(clear_rows), axis=1) > 0
    ratio = np.abs(logits - jlogits).max(-1) / (
        BF16_ROW_RTOL * np.abs(jlogits).max(-1))
    assert held.any()
    assert ratio[held].max() <= 1, ratio[held].max()


@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch",
                                    "selective"])
def test_remat_policies_match_no_remat(setup, policy):
    jparams, tokens = setup
    _, ref_cfg = _configs(remat=False)
    ref_loss, ref_grads = _loss_and_grads(ref_cfg, jparams, tokens)
    _, tcfg = _configs(remat_policy=policy)
    loss, grads = _loss_and_grads(tcfg, jparams, tokens)
    assert loss == pytest.approx(ref_loss, abs=1e-6)
    assert_trees_close(grads, ref_grads, rtol=1e-6)


def _policy_calls(monkeypatch, policy_name, run):
    """Run ``run()`` with the named remat policy wrapped: returns every op
    it decided on in the forward as (tag, op, saved). The policy is read
    from ``remat_policy_fn``'s context (a partial of
    ``create_selective_checkpoint_contexts``)."""
    calls = []
    orig = tl.remat_policy_fn

    def recording_policy_fn(name):
        assert name == policy_name
        context_fn = orig(name)
        policy = context_fn.args[0]

        def recording(ctx, op, *args, **kwargs):
            decision = policy(ctx, op, *args, **kwargs)
            if not ctx.is_recompute:
                calls.append((getattr(tl._tag, "name", None), op,
                              decision == CheckpointPolicy.MUST_SAVE))
            return decision
        return functools.partial(context_fn.func, recording)

    # both models reach it through llama's remat_layer
    monkeypatch.setattr(tl, "remat_policy_fn", recording_policy_fn)
    run()
    return calls


MM = torch.ops.aten.mm.default
INT_MM = torch.ops.aten._int_mm.default


def test_selective_saves_exactly_the_tagged_tensors(setup, monkeypatch):
    """Mixtral under "selective": per layer the four attention projections
    and the combined expert output, nothing else (the expert products,
    which the "dots" policies save, are recomputed). The policy's
    decisions are read op by op: PyTorch's saved-tensor hooks do not see
    inside a non-reentrant checkpoint, which stores what the policy
    saves itself."""
    jparams, tokens = setup
    _, tcfg = _configs(remat_policy="selective")
    calls = _policy_calls(monkeypatch, "selective", lambda: tm.loss_fn(
        _torch_params(jparams), torch.from_numpy(tokens), tcfg).backward())
    saved = [(tag, op) for tag, op, s in calls if s]
    per_layer = [("attn_q", MM), ("attn_k", MM), ("attn_v", MM),
                 ("attn_o", MM),
                 ("moe_out", torch.ops.aten._to_copy.default)]
    assert saved == per_layer * tcfg.n_layers
    products = sum(op is MM for _, op, _ in calls)
    # 4 projections, the router and 3 products per expert with tokens
    assert products > 5 * tcfg.n_layers


@pytest.mark.parametrize("int8_mlp", [False, True])
def test_llama_selective_saves_what_it_saved_before(monkeypatch, int8_mlp):
    """Llama under "selective" saves its 7 projection products per layer,
    the outputs of every 2-D product in the layer (aten.mm, and
    aten._int_mm with the int8 MLP), which is what its op rule saved
    before the tags."""
    cfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32,
                              remat_policy="selective", int8_mlp=int8_mlp)
    params = tl.init_params(cfg, device="cpu")
    for leaf in param_leaves(params):
        leaf.requires_grad_(True)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)))
    calls = _policy_calls(monkeypatch, "selective", lambda: tl.loss_fn(
        params, tokens, cfg).backward())
    saved = [(tag, op) for tag, op, s in calls if s]
    products = [(tag, op) for tag, op, _ in calls if op in (MM, INT_MM)]
    assert saved == products
    attn = [("attn_q", MM), ("attn_k", MM), ("attn_v", MM), ("attn_o", MM)]
    mlp = ([(None, INT_MM)] * 3 if int8_mlp else
           [("mlp_gate", MM), ("mlp_up", MM), ("mlp_down", MM)])
    assert saved == (attn + mlp) * cfg.n_layers


def test_segment_sizes_read_once_per_layer_and_recompute(setup):
    jparams, tokens = setup
    for remat, per_layer in ((False, 1), (True, 2)):
        _, tcfg = _configs(remat=remat)
        before = tmoe.sync_counts["segment_sizes"]
        tm.loss_fn(_torch_params(jparams), torch.from_numpy(tokens),
                   tcfg).backward()
        assert tmoe.sync_counts["segment_sizes"] - before == \
            per_layer * tcfg.n_layers


def test_counts_and_defaults_match_jax():
    for jcfg, tcfg in (
            (jm.MixtralConfig.tiny(), tm.MixtralConfig.tiny()),
            (jm.MixtralConfig.mixtral_8x7b(),
             tm.MixtralConfig.mixtral_8x7b()),
            (jm.MixtralConfig.mixtral_8x7b(n_layers=2),
             tm.MixtralConfig.mixtral_8x7b(n_layers=2))):
        assert tm.num_params(tcfg) == jm.num_params(jcfg)
        assert tm.active_params(tcfg) == jm.active_params(jcfg)
        for L in (16, 2048):
            assert tm.flops_per_token(tcfg, L) == jm.flops_per_token(jcfg, L)
    cut = tm.MixtralConfig.mixtral_8x7b(n_layers=2)
    assert tm.num_params(cut) == 3_033_616_384
    assert tm.active_params(cut) == 919_687_168
    assert tm.flops_per_token(cut, 2048) == pytest.approx(5.719e9,
                                                          rel=1e-3)
    defaults = dataclasses.asdict(tm.MixtralConfig())
    for field in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                  "ffn_dim", "n_experts", "top_k", "rope_theta", "norm_eps",
                  "aux_loss_coef", "remat", "remat_policy", "fsdp_overlap"):
        assert defaults[field] == getattr(jm.MixtralConfig(), field), field


def test_init_params_tree_matches_jax(setup):
    jparams, _ = setup
    _, tcfg = _configs()
    params = tm.init_params(tcfg, seed=1, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert {k: tuple(v.shape) if isinstance(v, torch.Tensor) else
            {n: tuple(t.shape) for n, t in v.items()}
            for k, v in params.items()} == shapes
    again = tm.init_params(tcfg, seed=1, device="cpu")
    for a, b in zip(param_leaves(params), param_leaves(again)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tm.init_params(tcfg)


def test_loss_decreases_with_sgd():
    """As tests/test_mixtral.py: one SGD step of 0.3 lowers the loss."""
    jcfg, tcfg = _configs()
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, tcfg.vocab_size, (4, 16)))
    params = _torch_params(jparams)
    l0 = tm.loss_fn(params, tokens, tcfg)
    l0.backward()
    assert torch.isfinite(l0)
    with torch.no_grad():
        for leaf in param_leaves(params):
            leaf -= 0.3 * leaf.grad
        assert tm.loss_fn(params, tokens, tcfg) < l0


def test_mesh_paths_and_unknown_policy_raise(setup):
    jparams, tokens = setup
    _, tcfg = _configs()
    params, batch = _torch_params(jparams), torch.from_numpy(tokens)
    with pytest.raises(ValueError, match="mesh"):
        tm.loss_fn(params, batch, tcfg, mesh=object())
    with pytest.raises(ValueError, match="mesh"):
        tm.forward(params, batch,
                   dataclasses.replace(tcfg, fsdp_overlap=True))
    with pytest.raises(ValueError, match="remat_policy"):
        tm.loss_fn(params, batch,
                   dataclasses.replace(tcfg, remat_policy="nope"))


def test_train_step_with_adafactor_matches_optax(setup):
    """Two steps of ``make_train_step`` with ``Adafactor(lr=1e-3)`` against
    the JAX package's with ``optax.adafactor(1e-3)``, each from optax's
    state; the 4-D expert leaves factor over their two largest dims."""
    jparams, tokens = setup
    jcfg, tcfg = _configs()
    jinit, jstep = jax_train_step(
        lambda p, b: jm.loss_fn(p, b, jcfg), optax.adafactor(1e-3),
        donate=False)
    init, step = make_train_step(functools.partial(tm.loss_fn, cfg=tcfg),
                                 functools.partial(Adafactor, lr=1e-3))
    jp, jstate = jparams, jinit(jparams)
    params = convert.from_jax(jparams, device="cpu")
    opt = init(params)
    batch = torch.from_numpy(tokens)
    for _ in range(2):
        load_adafactor_state(params, opt, jp, jstate)
        jp, jstate, jm_ = jstep(jp, jstate, jnp.asarray(tokens))
        _, opt, m = step(params, opt, batch)
        assert float(m["loss"]) == pytest.approx(float(jm_["loss"]),
                                                 abs=LOSS_TOL)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm_["grad_norm"]), rel=1e-5)
        assert_trees_close(params, jp, rtol=PARAM_RTOL)
        _assert_state_close(opt, params, jstate, STATE_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trips_the_mixtral_tree(setup, dtype):
    jparams, _ = setup
    tree = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), jparams)
    params = convert.from_jax(tree, device="cpu")
    assert params["layers"]["w_in"].shape == (2, 4, 64, 96)
    assert params["layers"]["w_in"].dtype == getattr(torch, dtype)
    back = convert.to_numpy(params)
    for got, want in zip(_leaves_np(back), _leaves_np(tree)):
        np.testing.assert_array_equal(got, want)


def test_chip_smoke_mixtral_phases_run_on_the_cpu():
    """chip_smoke.py's phase 10 at a tiny size: training under both remat
    policies (losses fall, no port kernel launched, the host reads
    counted), bf16 routing against fp32, and the oracle (CPU against
    CPU)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    cpu = torch.device("cpu")
    tiny = dict(vocab_size=512, dim=64, n_heads=8, n_kv_heads=4,
                ffn_dim=96, n_experts=4, n_layers=2)
    params, cfg = chip_smoke.phase_mixtral(cpu, tiny, (2, 32),
                                           profile=False)
    chip_smoke.phase_mixtral_routing(cpu, params, cfg, (1, 64))
    chip_smoke.phase_mixtral_oracle(cpu, dict(tiny, dim=128), (2, 32))
