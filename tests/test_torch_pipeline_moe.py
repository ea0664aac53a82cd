"""The port's pipeline and expert parallelism against the JAX package's, on
the CPU.

One ``TorchTrainer`` run of 4 gloo ranks computes every case on the
meshes it builds in turn; the JAX side runs the same shapes over 4 of its
8 virtual CPU devices:

- ``pipeline_apply`` over pp 4 (6 microbatches through 4 tanh stages):
  the output against JAX's under ``shard_map`` and against the stages
  applied in sequence, the gradients against the sequential function's;
- Llama with pp 2: "full" attention with dp 2 and with tp 2, "ring" with
  sp 2: the einsum ring inside the pipeline (what CPU tensors run) and
  the fused ring over the plain flash versions (``use_kernel=True``, the
  path CUDA tensors take), both against the JAX package's pipelined
  ring (its einsum ring); loss and every gradient leaf against the JAX
  ``loss_fn`` on its mesh;
- ``moe_ffn_sharded`` at ep 4 (a mesh of one "ep" axis) and ep 2 (a
  hand-made ("dp", "ep") mesh, both dp rows routing the same tokens),
  gated and not, at capacity factors 8 (no drops: also against the dense
  ``moe_ffn``), 1.25 and 0.5 (drops, equal to JAX's, finite): outputs and
  the gradients of sum(out²);
- ``moe_ffn_sharded`` on dp 2 x ep 2 with a different batch on each dp
  row, at capacity factors 1.25 and 0.5 (drops): the port's buckets are
  a rank's own (capacity from its t tokens), where the JAX package's ep
  shard spans T/ep tokens across dp, so the drops differ from JAX's at
  dp > 1. Each dp row held against a plain per-rank capacity reference
  (``_per_rank_capacity_moe``: the dense experts with the dropped
  (token, k) weighted 0) and against JAX's ``moe_ffn_sharded`` on that
  row's tokens alone, outputs and gradients;
- Mixtral on the ("dp", "ep") mesh: logits, loss and gradients at
  capacity factor 8 against the JAX package's ep forward and loss, one
  SGD step lowering the loss at the default factor (as
  tests/test_mixtral.py), and the fsdp-overlap loss on dp 2 x fsdp 2
  against ``_loss_overlap``.

Tolerances: fp32 on both sides: outputs and gradients to 1e-5 of their
largest value (pipeline: 1e-6), losses to 2e-4 relative
(tests/test_torch_sharded_train.py's limits).
"""

import functools

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import convert, train
from ray_tpu_torch.parallel.mesh import MeshSpec

LOSS_RTOL = 2e-4
GRAD_RTOL = 1e-5
PIPE_RTOL = 1e-6
PIPE = dict(n_stages=4, n_micro=6, B=3, F=5)
TOKENS = (4, 16)
#: mesh -> the pipelined Llama attentions on it
PP_CASES = {"pp2_dp2": ("full",), "pp2_tp2": ("full",),
            "pp2_sp2": ("ring", "ring_fused")}
#: a case -> the attention it configures ("ring_fused": "ring" with the
#: fused ring forced on the CPU tensors)
PP_ATTENTION = {"ring_fused": "ring"}
PP_MESHES = {"pp2_dp2": dict(pp=2, dp=2), "pp2_tp2": dict(pp=2, tp=2),
             "pp2_sp2": dict(pp=2, sp=2)}
MOE = dict(T=64, dim=16, ffn=32, E=8)
MOE_CASES = [(ep, gated, cf) for ep in (4, 2) for gated in (False, True)
             for cf in (8.0, 1.25, 0.5)]
#: (gated, capacity factor) on dp 2 x ep 2, a batch per dp row
MOE_DP_CASES = [(gated, cf) for gated in (False, True) for cf in (1.25, 0.5)]
MIXTRAL = dict(B=4, L=16)


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, _system_config={
        "object_store_memory_bytes": 128 * 1024 * 1024,
        "worker_pool_prestart": 4,
    })
    yield rt
    rt.shutdown()


def _make_loop():
    def loop(cfg):
        import dataclasses
        import importlib

        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor

        from ray_tpu_torch import train
        from ray_tpu_torch.models import llama as tl
        from ray_tpu_torch.models import mixtral as tm
        from ray_tpu_torch.parallel.fsdp_overlap import project_specs
        from ray_tpu_torch.parallel.mesh import (AXIS_ORDER, MeshSpec,
                                                 axis_index, build_mesh)
        from ray_tpu_torch.parallel.moe import moe_ffn_sharded
        from ray_tpu_torch.parallel.pipeline import pipeline_apply
        from ray_tpu_torch.train.train_step import (local_shard,
                                                    param_leaves,
                                                    reduce_gradients)

        # the module (the package's ``ring_attention`` is its function)
        ra = importlib.import_module("ray_tpu_torch.parallel.ring_attention")
        torch.set_num_threads(1)
        rank, world = dist.get_rank(), dist.get_world_size()
        out = {}

        def tree_of(arrays):
            return {k: ({n: torch.tensor(a) for n, a in v.items()}
                        if isinstance(v, dict) else torch.tensor(v))
                    for k, v in arrays.items()}

        def sharded_loss_grads(loss_fn, arrays, model_cfg, specs, tokens,
                               mesh):
            params = train.shard_params(tree_of(arrays), mesh, specs)
            loc = {k: ({n: local_shard(t) for n, t in v.items()}
                       if isinstance(v, dict) else local_shard(v))
                   for k, v in params.items()}
            leaves = param_leaves(loc)
            for t in leaves:
                t.requires_grad_(True)
            loss = loss_fn(loc, train.shard_batch(tokens, mesh), model_cfg,
                           mesh=mesh)
            loss.backward()
            reduce_gradients(leaves)
            grads = [DTensor.from_local(
                t.grad, mesh, t.shard_info.placements,
                run_check=False).full_tensor().numpy() for t in leaves]
            return loss.item(), grads if rank == 0 else None

        # -- pipeline_apply over pp 4
        mesh = build_mesh(MeshSpec(pp=4))
        s = axis_index(mesh, "pp")
        w = torch.tensor(cfg["pipe_w"][s:s + 1]).requires_grad_()
        xs = torch.tensor(cfg["pipe_xs"]).requires_grad_()
        y = pipeline_apply(lambda p, x: torch.tanh(x @ p[0]), w, xs, mesh)
        # every stage holds the output: each takes 1/pp of the objective
        ((y * torch.tensor(cfg["pipe_c"])).sum() / 4).backward()
        # only stage 0 reads the microbatches
        dxs = xs.grad if xs.grad is not None else torch.zeros_like(xs)
        out["pipe"] = {"stage": s, "y": y.detach().numpy(),
                       "dw": w.grad.numpy(), "dxs": dxs.numpy()}

        # -- Llama with pp 2
        tokens = torch.tensor(cfg["tokens"])
        for mname, spec in cfg["pp_meshes"].items():
            mesh = build_mesh(MeshSpec(**spec))
            for att in cfg["pp_cases"][mname]:
                tcfg = tl.LlamaConfig.tiny(
                    n_layers=2, dtype=torch.float32, pp_microbatches=2,
                    attention=cfg["pp_attention"].get(att, att))
                sharded = ra.ring_attention_sharded

                def fused(*args, use_kernel=None, **kw):
                    return sharded(*args, use_kernel=True, **kw)

                if att == "ring_fused":     # the path of CUDA tensors
                    ra.ring_attention_sharded = fused
                try:
                    out[f"{mname}_{att}"] = sharded_loss_grads(
                        tl.loss_fn, cfg["llama"], tcfg, tl.param_specs(tcfg),
                        tokens, mesh)
                finally:
                    ra.ring_attention_sharded = sharded
                if att.startswith("ring"):
                    out[f"{mname}_{att}_path"] = ra.last_ring_path()
            if mname == "pp2_dp2":
                try:
                    tl.loss_fn(tree_of(cfg["llama"]), tokens,
                               dataclasses.replace(tcfg, attention="ulysses"),
                               mesh=mesh)
                    out["pp_ulysses"] = "ran"
                except ValueError as e:
                    out["pp_ulysses"] = str(e)

        # -- moe_ffn_sharded at ep 4 and ep 2 (over dp 2)
        meshes = {4: init_device_mesh("cpu", (4,), mesh_dim_names=("ep",)),
                  2: init_device_mesh("cpu", (2, 2),
                                      mesh_dim_names=("dp", "ep"))}
        for ep, gated, cf in cfg["moe_cases"]:
            mesh = meshes[ep]
            e = axis_index(mesh, "ep")
            full = cfg["moe_gated" if gated else "moe"]
            E = full["router"].shape[1]
            params = {k: torch.tensor(v if k == "router" else
                                      v[e * E // ep:(e + 1) * E // ep])
                      .requires_grad_() for k, v in full.items()}
            T = cfg["moe_x"].shape[0]
            x = torch.tensor(cfg["moe_x"][e * T // ep:(e + 1) * T // ep]
                             ).requires_grad_()
            y = moe_ffn_sharded(params, x, mesh, capacity_factor=cf)
            (y ** 2).sum().backward()
            out[f"moe_{ep}_{gated}_{cf}"] = {
                "coord": (axis_index(mesh, "dp"), e), "y": y.detach().numpy(),
                "dx": x.grad.numpy(),
                "grads": {k: t.grad.numpy() for k, t in params.items()}}

        # -- moe_ffn_sharded on dp 2 x ep 2, each dp row its own tokens
        mesh = meshes[2]
        d, e = axis_index(mesh, "dp"), axis_index(mesh, "ep")
        for gated, cf in cfg["moe_dp_cases"]:
            full = cfg["moe_gated" if gated else "moe"]
            E = full["router"].shape[1]
            params = {k: torch.tensor(v if k == "router" else
                                      v[e * E // 2:(e + 1) * E // 2])
                      .requires_grad_() for k, v in full.items()}
            rows = cfg["moe_x_rows"]
            T = rows.shape[1]
            x = torch.tensor(rows[d, e * T // 2:(e + 1) * T // 2]
                             ).requires_grad_()
            y = moe_ffn_sharded(params, x, mesh, capacity_factor=cf)
            (y ** 2).sum().backward()
            out[f"moe_dp_{gated}_{cf}"] = {
                "coord": (d, e), "y": y.detach().numpy(),
                "dx": x.grad.numpy(),
                "grads": {k: t.grad.numpy() for k, t in params.items()}}

        # -- Mixtral on (dp 2, ep 2)
        mesh = meshes[2]
        d, e = axis_index(mesh, "dp"), axis_index(mesh, "ep")
        mcfg = tm.MixtralConfig.tiny(dtype=torch.float32, remat=False,
                                     capacity_factor=8.0)
        E, B = mcfg.n_experts, cfg["mix_tokens"].shape[0]

        def local_params():
            tree = tree_of(cfg["mixtral"])
            for k in ("w_gate", "w_in", "w_out"):
                tree["layers"][k] = tree["layers"][k][:, e * E // 2:
                                                      (e + 1) * E // 2]
            tree["layers"] = {k: v.contiguous().requires_grad_()
                              for k, v in tree["layers"].items()}
            for k in ("embed", "final_norm"):
                tree[k].requires_grad_()
            return tree

        toks = torch.tensor(cfg["mix_tokens"][d * B // 2:(d + 1) * B // 2])
        params = local_params()
        logits = tm.forward(params, toks, mcfg, mesh=mesh)
        loss = tm.loss_fn(params, toks, mcfg, mesh=mesh)
        loss.backward()
        out["mixtral"] = {"coord": (d, e), "logits": logits.detach().numpy(),
                          "loss": loss.item(),
                          "grads": {k: (t.grad.numpy() if k != "layers"
                                        else {n: g.grad.numpy()
                                              for n, g in t.items()})
                                    for k, t in params.items()}}
        # one SGD step of 0.3 at the default capacity factor
        dcfg = dataclasses.replace(mcfg, capacity_factor=1.25)
        params = local_params()
        l0 = tm.loss_fn(params, toks, dcfg, mesh=mesh)
        l0.backward()
        with torch.no_grad():
            for name, t in [("embed", params["embed"]),
                            ("final_norm", params["final_norm"]),
                            *params["layers"].items()]:
                g = t.grad.clone()
                axes = (("dp",) if name in ("w_gate", "w_in", "w_out")
                        else ("dp", "ep"))
                for a in axes:
                    dist.all_reduce(g, group=mesh.get_group(a))
                t -= 0.3 * g
            l1 = tm.loss_fn(params, toks, dcfg, mesh=mesh)
        out["mixtral_sgd"] = (l0.item(), l1.item())

        # -- Mixtral's prefetching fsdp loss on dp 2 x fsdp 2
        mesh = build_mesh(MeshSpec(dp=2, fsdp=2))
        ocfg = tm.MixtralConfig.tiny(dtype=torch.float32, remat=False,
                                     fsdp_overlap=True)
        specs = project_specs(tm.param_specs(ocfg), AXIS_ORDER)
        out["mixtral_overlap"] = sharded_loss_grads(
            tm.loss_fn, cfg["mixtral"], ocfg, specs,
            torch.tensor(cfg["mix_tokens"]), mesh)

        gathered = [None] * world
        dist.all_gather_object(gathered, out)
        train.report({"ranks": gathered})
    return loop


# ----------------------------------------------------------- the inputs


def _pipe_inputs():
    rng = np.random.default_rng(0)
    p = PIPE
    w = (rng.standard_normal((p["n_stages"], p["F"], p["F"])) * 0.3
         ).astype(np.float32)
    xs = rng.standard_normal((p["n_micro"], p["B"], p["F"])
                             ).astype(np.float32)
    c = rng.standard_normal(xs.shape).astype(np.float32)
    return w, xs, c


def _moe_params(gated):
    import jax

    from ray_tpu.parallel.moe import init_moe_params
    p = init_moe_params(jax.random.PRNGKey(0), dim=MOE["dim"],
                        ffn_dim=MOE["ffn"], num_experts=MOE["E"])
    out = {k: np.asarray(v) for k, v in p.items()}
    if gated:
        out["w_gate"] = (np.random.default_rng(5).standard_normal(
            out["w_in"].shape) * MOE["dim"] ** -0.5).astype(np.float32)
    return out


def _moe_x():
    return np.random.default_rng(2).standard_normal(
        (MOE["T"], MOE["dim"])).astype(np.float32)


def _moe_x_rows():
    """[dp 2, T, dim]: each dp row's own tokens."""
    return np.random.default_rng(6).standard_normal(
        (2, MOE["T"], MOE["dim"])).astype(np.float32)


def _llama_setup():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    params = jl.init_params(jl.LlamaConfig.tiny(n_layers=2,
                                                dtype=jnp.float32),
                            jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, 256, TOKENS).astype(np.int32)
    return params, tokens


def _mixtral_setup(**kw):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import mixtral as jm
    jcfg = jm.MixtralConfig.tiny(dtype=jnp.float32, remat=False, **kw)
    params = jm.init_params(jcfg, jax.random.PRNGKey(1))
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (MIXTRAL["B"], MIXTRAL["L"])).astype(np.int32)
    return jcfg, params, tokens


@pytest.fixture(scope="module")
def port_results(cluster, tmp_path_factory):
    w, xs, c = _pipe_inputs()
    lparams, tokens = _llama_setup()
    _, mparams, mtokens = _mixtral_setup()
    result = train.TorchTrainer(
        _make_loop(),
        train_loop_config={
            "pipe_w": w, "pipe_xs": xs, "pipe_c": c,
            "pp_meshes": PP_MESHES, "pp_cases": PP_CASES,
            "pp_attention": PP_ATTENTION,
            "llama": convert.to_numpy(convert.from_jax(lparams, "cpu")),
            "tokens": tokens.astype(np.int64),
            "moe": _moe_params(False), "moe_gated": _moe_params(True),
            "moe_x": _moe_x(), "moe_cases": MOE_CASES,
            "moe_x_rows": _moe_x_rows(), "moe_dp_cases": MOE_DP_CASES,
            "mixtral": convert.to_numpy(convert.from_jax(mparams, "cpu")),
            "mix_tokens": mtokens.astype(np.int64)},
        scaling_config=train.ScalingConfig(num_workers=4,
                                           mesh=MeshSpec(dp=4)),
        run_config=train.RunConfig(
            storage_path=str(tmp_path_factory.mktemp("ppmoe")))).fit()
    return result.metrics["ranks"]


def _close(got, want, rtol=GRAD_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max() + 1e-7)


# ------------------------------------------------------------- pipeline


def test_pipeline_apply_matches_jax_and_sequential(port_results):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as JP

    from ray_tpu.parallel.mesh import shard_map_compat
    from ray_tpu.parallel.pipeline import pipeline_apply
    w, xs, c = _pipe_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("pp",))

    def run(w, xs):
        return pipeline_apply(lambda p, x: jnp.tanh(x @ p[0]), w, xs,
                              axis_name="pp")

    jax_out = np.asarray(jax.jit(shard_map_compat(
        run, mesh=mesh, in_specs=(JP("pp"), JP()), out_specs=JP()))(w, xs))

    def sequential(w, xs):
        for i in range(PIPE["n_stages"]):
            xs = jnp.tanh(xs @ w[i])
        return xs

    seq = np.asarray(sequential(w, xs))
    dw, dxs = jax.grad(lambda w, xs: (sequential(w, xs) * c).sum(),
                       argnums=(0, 1))(w, xs)
    ranks = sorted((r["pipe"] for r in port_results),
                   key=lambda p: p["stage"])
    for p in ranks:                     # every stage holds the output
        _close(p["y"], jax_out, PIPE_RTOL)
        _close(p["y"], seq, PIPE_RTOL)
    _close(np.concatenate([p["dw"] for p in ranks]), np.asarray(dw),
           PIPE_RTOL)
    _close(sum(p["dxs"] for p in ranks), np.asarray(dxs), PIPE_RTOL)


@pytest.mark.parametrize("mname,att", [(m, a) for m, atts in
                                       PP_CASES.items() for a in atts])
def test_pipelined_llama_loss_and_grads_match_jax(port_results, mname,
                                                  att):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec, build_mesh
    params, tokens = _llama_setup()
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32,
                               attention=PP_ATTENTION.get(att, att),
                               pp_microbatches=2)
    mesh = build_mesh(JMeshSpec(**PP_MESHES[mname]),
                      devices=jax.devices()[:4])
    if att.startswith("ring"):          # the ring the port's stages ran
        want_path = "fused" if att == "ring_fused" else "einsum"
        assert {r[f"{mname}_{att}_path"] for r in port_results} == \
            {want_path}
    value, grads = jax.jit(jax.value_and_grad(functools.partial(
        jl.loss_fn, cfg=jcfg, mesh=mesh)))(params, jnp.asarray(tokens))
    for r in port_results:
        assert r[f"{mname}_{att}"][0] == pytest.approx(float(value),
                                                       rel=LOSS_RTOL)
    got = port_results[0][f"{mname}_{att}"][1]
    want = [np.asarray(g) for g in jax.tree.leaves(grads)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


def test_pipeline_with_ulysses_raises_as_jax(port_results):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec, build_mesh
    params, tokens = _llama_setup()
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32,
                               attention="ulysses", pp_microbatches=2)
    mesh = build_mesh(JMeshSpec(**PP_MESHES["pp2_dp2"]),
                      devices=jax.devices()[:4])
    with pytest.raises(ValueError) as err:
        jl.loss_fn(params, jnp.asarray(tokens), jcfg, mesh=mesh)
    for r in port_results:
        assert r["pp_ulysses"] == str(err.value)


# ------------------------------------------------------------------- MoE


def _assemble_moe(port_results, key, ep, row=0):
    """(y [T, d], dx [T, d], {leaf: grad}) from the ranks of dp row
    ``row``: token blocks and expert blocks in ep order, the router's
    gradient summed over the ep ranks."""
    rows = sorted((r[key] for r in port_results
                   if r[key]["coord"][0] == row),
                  key=lambda p: p["coord"][1])
    assert len(rows) == ep
    grads = {k: (sum(p["grads"][k] for p in rows) if k == "router" else
                 np.concatenate([p["grads"][k] for p in rows]))
             for k in rows[0]["grads"]}
    return (np.concatenate([p["y"] for p in rows]),
            np.concatenate([p["dx"] for p in rows]), grads)


@pytest.mark.parametrize("ep,gated,cf", MOE_CASES)
def test_moe_ffn_sharded_matches_jax(port_results, ep, gated, cf):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ray_tpu.parallel.moe import moe_ffn, moe_ffn_sharded
    params = {k: jnp.asarray(v) for k, v in _moe_params(gated).items()}
    x = jnp.asarray(_moe_x())
    mesh = Mesh(np.asarray(jax.devices()[:ep]), ("ep",))
    fn = functools.partial(moe_ffn_sharded, mesh=mesh, top_k=2,
                           capacity_factor=cf)
    want = np.asarray(jax.jit(fn)(params, x))
    dp, dx = jax.jit(jax.grad(lambda p, x: (fn(p, x) ** 2).sum(),
                              argnums=(0, 1)))(params, x)
    y, got_dx, grads = _assemble_moe(port_results, f"moe_{ep}_{gated}_{cf}",
                                     ep)
    assert np.isfinite(y).all()
    _close(y, want)
    _close(got_dx, np.asarray(dx))
    for k in params:
        _close(grads[k], np.asarray(dp[k]))
    if cf == 8.0:       # no drops: the dense function
        _close(y, np.asarray(moe_ffn(params, x, top_k=2)))
    if cf == 0.5:       # drops: bounded, and some token lost an expert
        assert not np.allclose(y, np.asarray(moe_ffn(params, x, top_k=2)))


def _per_rank_capacity_moe(params, x, ep, capacity_factor, top_k=2):
    """The plain function of the port's drop rule: x's ep blocks, each a
    rank's tokens; per block, every expert on every token (the JAX
    ``_expert_ffn``), each (token, k) weighted by its renormalized top-k
    weight, or by 0 past the first ceil(t·k/E·factor) of that block's
    assignments to its expert, in token order."""
    import math

    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel.moe import _expert_ffn, _routing
    E = params["router"].shape[1]
    outs = []
    for xb in jnp.split(x, ep):
        t = xb.shape[0]
        cap = max(1, math.ceil(t * top_k / E * capacity_factor))
        idx, w = _routing(params, xb, top_k)                # [t, k]
        onehot = jax.nn.one_hot(idx.reshape(-1), E, dtype=jnp.int32)
        slot = ((jnp.cumsum(onehot, 0) - 1) * onehot).sum(-1)
        w = w * (slot < cap).reshape(t, top_k)
        ys = jnp.stack([_expert_ffn(
            params["w_in"][e], params["w_out"][e], xb,
            params["w_gate"][e] if "w_gate" in params else None)
            for e in range(E)])                              # [E, t, d]
        outs.append(sum(w[:, k, None] * ys[idx[:, k], jnp.arange(t)]
                        for k in range(top_k)))
    return jnp.concatenate(outs)


@pytest.mark.parametrize("gated,cf", MOE_DP_CASES)
def test_moe_ffn_sharded_over_dp_keeps_per_rank_buckets(port_results,
                                                        gated, cf):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ray_tpu.parallel.moe import moe_ffn, moe_ffn_sharded
    params = {k: jnp.asarray(v) for k, v in _moe_params(gated).items()}
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("ep",))
    jax_fn = functools.partial(moe_ffn_sharded, mesh=mesh, top_k=2,
                               capacity_factor=cf)
    ref_fn = functools.partial(_per_rank_capacity_moe, ep=2,
                               capacity_factor=cf)
    for row, x in enumerate(_moe_x_rows()):
        x = jnp.asarray(x)
        y, got_dx, grads = _assemble_moe(port_results, f"moe_dp_{gated}_{cf}",
                                         2, row)
        assert np.isfinite(y).all()
        # some (token, k) of this row dropped
        assert not np.allclose(y, np.asarray(moe_ffn(params, x, top_k=2)))
        for fn in (ref_fn, jax.jit(jax_fn)):
            dp, dx = jax.grad(lambda p, x: (fn(p, x) ** 2).sum(),
                              argnums=(0, 1))(params, x)
            _close(y, np.asarray(fn(params, x)))
            _close(got_dx, np.asarray(dx))
            for k in params:
                _close(grads[k], np.asarray(dp[k]))


# --------------------------------------------------------------- Mixtral


def _jax_mixtral_mesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "ep"))


def test_mixtral_ep_forward_loss_and_grads_match_jax(port_results):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import mixtral as jm
    jcfg, params, tokens = _mixtral_setup(capacity_factor=8.0)
    mesh = _jax_mixtral_mesh()
    with mesh:
        logits = np.asarray(jax.jit(functools.partial(
            jm.forward, cfg=jcfg, mesh=mesh))(params, tokens))
        value, grads = jax.jit(jax.value_and_grad(functools.partial(
            jm.loss_fn, cfg=jcfg, mesh=mesh)))(params, tokens)
    dense = np.asarray(jm.forward(params, tokens, jcfg))
    ranks = [r["mixtral"] for r in port_results]
    B, E = MIXTRAL["B"], jcfg.n_experts
    for r in ranks:
        d = r["coord"][0]
        _close(r["logits"], logits[d * B // 2:(d + 1) * B // 2])
        _close(r["logits"], dense[d * B // 2:(d + 1) * B // 2])
        assert r["loss"] == pytest.approx(float(value), rel=LOSS_RTOL)
    # each rank holds 1/4 of the gradient: replicated leaves summed over
    # every rank, the experts over dp and laid out in ep order
    experts = ("w_gate", "w_in", "w_out")
    for k, want in grads["layers"].items():
        if k in experts:
            got = np.concatenate([sum(r["grads"]["layers"][k] for r in ranks
                                      if r["coord"][1] == e)
                                  for e in range(2)], axis=1)
            assert got.shape[1] == E
        else:
            got = sum(r["grads"]["layers"][k] for r in ranks)
        _close(got, np.asarray(want))
    for k in ("embed", "final_norm"):
        _close(sum(r["grads"][k] for r in ranks), np.asarray(grads[k]))


def test_mixtral_ep_sgd_step_decreases_loss(port_results):
    losses = {r["mixtral_sgd"] for r in port_results}
    assert len(losses) == 1           # one loss, held by every rank
    (l0, l1), = losses
    assert np.isfinite(l0) and l1 < l0


def test_mixtral_fsdp_overlap_loss_matches_jax(port_results):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import mixtral as jm
    from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec, build_mesh
    from ray_tpu.train.train_step import shard_params
    from ray_tpu.parallel.fsdp_overlap import project_specs
    jcfg, params, tokens = _mixtral_setup(fsdp_overlap=True)
    mesh = build_mesh(JMeshSpec(dp=2, fsdp=2), devices=jax.devices()[:4])
    specs = project_specs(jm.param_specs(jcfg),
                          ("pp", "dp", "fsdp", "sp", "tp"))
    with mesh:
        value, grads = jax.jit(jax.value_and_grad(functools.partial(
            jm.loss_fn, cfg=jcfg, mesh=mesh)))(
                shard_params(params, mesh, specs), jnp.asarray(tokens))
    for r in port_results:
        assert r["mixtral_overlap"][0] == pytest.approx(float(value),
                                                        rel=LOSS_RTOL)
    got = port_results[0]["mixtral_overlap"][1]
    want = [np.asarray(g) for g in jax.tree.leaves(grads)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


def test_mlp_specs_match_jax():
    from ray_tpu.models.mlp import MLPConfig as JMLPConfig, mlp_specs as js
    from ray_tpu_torch.models.mlp import MLPConfig, mlp_specs
    for kw in ({}, {"n_hidden": 1}, {"n_hidden": 3, "hidden": 64}):
        assert [{k: tuple(v) for k, v in layer.items()}
                for layer in mlp_specs(MLPConfig(**kw))] == \
            [{k: tuple(v) for k, v in layer.items()}
             for layer in js(JMLPConfig(**kw))]
