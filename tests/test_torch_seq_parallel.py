"""The port's sequence parallelism against the JAX package's, on the CPU.

One ``TorchTrainer`` run of 4 gloo ranks builds three meshes in turn (sp
4; dp 2 x sp 2; sp 2 x tp 2) and on each computes every case; the JAX
side runs the same mesh shapes over 4 of its 8 virtual CPU devices.

- Ring attention (the einsum ring, and the fused ring's structure over
  the plain flash versions), Ulysses: causal and not, each rank's output
  block and the gradients of a seeded cotangent, against
  ``ring_attention_sharded`` (einsum, and the fused Pallas path in
  interpret mode) and ``ulysses_attention_sharded``.
- Llama's loss and every gradient leaf with ``attention`` "ring",
  "ulysses", "full" and "flash" at sp 2, with dp 2 and with tp 2, against
  the JAX ``loss_fn`` on its mesh (the port's tokens sharded over sp,
  rope positions offset by the block's start; the next-token labels
  crossing the blocks).

Tolerances: fp32 on both sides, differing only in the order of fp32 sums:
attention outputs and gradients to 1e-5 of their largest value; the loss
to 2e-4 relative and the gradients to 1e-5 of their leaf's largest value
(tests/test_torch_sharded_train.py's limits).
"""

import functools

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import convert, train
from ray_tpu_torch.parallel.mesh import MeshSpec

ATTN_RTOL = 1e-5
LOSS_RTOL = 2e-4
GRAD_RTOL = 1e-5
QKV = (2, 32, 8, 8)          # B, L, H, D
TOKENS = (4, 32)             # B, L
MESHES = {"sp4": dict(sp=4), "dp2_sp2": dict(dp=2, sp=2),
          "sp2_tp2": dict(sp=2, tp=2)}
#: case -> (kind, causal)
ATTN_CASES = {"ring": ("ring", True), "ring_bidir": ("ring", False),
              "ring_fused": ("ring_fused", True),
              "ring_fused_bidir": ("ring_fused", False),
              "ulysses": ("ulysses", True),
              "ulysses_bidir": ("ulysses", False)}
#: mesh -> the Llama attentions computed on it
LLAMA_CASES = {"dp2_sp2": ("ring", "ulysses", "full", "flash"),
               "sp2_tp2": ("ring", "ulysses")}


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
        import torch
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor

        from ray_tpu_torch import train
        from ray_tpu_torch.models import llama as tl
        from ray_tpu_torch.parallel.mesh import (AXIS_ORDER, MeshSpec,
                                                 build_mesh)
        from ray_tpu_torch.parallel.ring_attention import (
            last_ring_path, ring_attention_sharded)
        from ray_tpu_torch.parallel.ulysses import ulysses_attention_sharded
        from ray_tpu_torch.train.train_step import (local_shard,
                                                    param_leaves,
                                                    reduce_gradients)

        torch.set_num_threads(1)
        rank = dist.get_rank()
        out = {}
        for mname, spec in cfg["meshes"].items():
            mesh = build_mesh(MeshSpec(**spec))
            coord = dict(zip(AXIS_ORDER, mesh.get_coordinate()))
            deg = {a: mesh.size(i) for i, a in enumerate(AXIS_ORDER)}

            def local(a):
                """[B, L, H, D] -> this rank's batch, sequence and head
                block."""
                B, L, H, _ = a.shape
                b, n, h = (B // (deg["dp"] * deg["fsdp"]), L // deg["sp"],
                           H // deg["tp"])
                bi = coord["dp"] * deg["fsdp"] + coord["fsdp"]
                si, hi = coord["sp"], coord["tp"]
                return torch.tensor(a[bi * b:(bi + 1) * b,
                                      si * n:(si + 1) * n,
                                      hi * h:(hi + 1) * h])

            res = {"coord": coord}
            for case, (kind, causal) in cfg["attn_cases"].items():
                q, k, v = (local(a).requires_grad_() for a in cfg["qkv"])
                if kind == "ulysses":
                    o = ulysses_attention_sharded(q, k, v, mesh,
                                                  causal=causal)
                else:
                    o = ring_attention_sharded(
                        q, k, v, mesh, causal=causal,
                        use_kernel=kind == "ring_fused")
                    want = "fused" if kind == "ring_fused" else "einsum"
                    assert last_ring_path() == want
                (o * local(cfg["w"])).sum().backward()
                res[case] = [t.detach().numpy()
                             for t in (o, q.grad, k.grad, v.grad)]
            tokens = train.shard_batch(torch.tensor(cfg["tokens"]), mesh)
            for att in cfg["llama"].get(mname, ()):
                tcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32,
                                           attention=att)
                tree = {k: ({n: torch.tensor(a) for n, a in v.items()}
                            if isinstance(v, dict) else torch.tensor(v))
                        for k, v in cfg["params"].items()}
                params = train.shard_params(tree, mesh, tl.param_specs(tcfg))
                loc = {k: ({n: local_shard(t) for n, t in v.items()}
                           if isinstance(v, dict) else local_shard(v))
                       for k, v in params.items()}
                leaves = param_leaves(loc)
                for t in leaves:
                    t.requires_grad_(True)
                loss = tl.loss_fn(loc, tokens, tcfg, mesh=mesh)
                loss.backward()
                reduce_gradients(leaves)
                grads = [DTensor.from_local(
                    t.grad, mesh, t.shard_info.placements,
                    run_check=False).full_tensor().numpy() for t in leaves]
                res["llama_" + att] = (loss.item(),
                                       grads if rank == 0 else None)
            out[mname] = res
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, out)
        train.report({"ranks": gathered})
    return loop


def _inputs():
    rng = np.random.default_rng(0)
    qkv = [rng.standard_normal(QKV).astype(np.float32) for _ in range(3)]
    w = rng.standard_normal(QKV).astype(np.float32)
    return qkv, w


def _jax_llama_setup():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    params = jl.init_params(jl.LlamaConfig.tiny(n_layers=2,
                                                dtype=jnp.float32),
                            jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, 256, TOKENS).astype(np.int32)
    return params, tokens


@pytest.fixture(scope="module")
def port_results(cluster, tmp_path_factory):
    qkv, w = _inputs()
    params, tokens = _jax_llama_setup()
    result = train.TorchTrainer(
        _make_loop(),
        train_loop_config={
            "meshes": MESHES, "attn_cases": ATTN_CASES, "qkv": qkv, "w": w,
            "llama": LLAMA_CASES, "tokens": tokens.astype(np.int64),
            "params": convert.to_numpy(convert.from_jax(params, "cpu"))},
        scaling_config=train.ScalingConfig(num_workers=4,
                                           mesh=MeshSpec(sp=4)),
        run_config=train.RunConfig(
            storage_path=str(tmp_path_factory.mktemp("seq")))).fit()
    return result.metrics["ranks"]


def _jax_mesh(spec):
    import jax

    from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec, build_mesh
    return build_mesh(JMeshSpec(**spec), devices=jax.devices()[:4])


def _assemble(ranks, mname, case, i, shape, spec):
    """The global array of piece ``i`` of ``case`` from every rank's
    block (batch over dp, sequence over sp, heads over tp)."""
    deg = {a: spec.get(a, 1) for a in ("dp", "fsdp", "sp", "tp")}
    out = np.zeros(shape, np.float32)
    B, L, H, _ = shape
    b, n, h = B // (deg["dp"] * deg["fsdp"]), L // deg["sp"], H // deg["tp"]
    for r in ranks:
        c = r[mname]["coord"]
        bi = c["dp"] * deg["fsdp"] + c["fsdp"]
        out[bi * b:(bi + 1) * b, c["sp"] * n:(c["sp"] + 1) * n,
            c["tp"] * h:(c["tp"] + 1) * h] = r[mname][case][i]
    return out


def _close(got, want, rtol):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max() + 1e-7)


@pytest.mark.parametrize("mname,case", [(m, c) for m in MESHES
                                        for c in ATTN_CASES])
def test_attention_matches_jax(port_results, mname, case):
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel.ring_attention import ring_attention_sharded
    from ray_tpu.parallel.ulysses import ulysses_attention_sharded
    kind, causal = ATTN_CASES[case]
    mesh = _jax_mesh(MESHES[mname])
    if kind == "ulysses":
        fn = functools.partial(ulysses_attention_sharded, mesh=mesh,
                               causal=causal)
    else:
        fused = kind == "ring_fused"
        fn = functools.partial(ring_attention_sharded, mesh=mesh,
                               causal=causal, use_kernel=fused,
                               interpret=fused)
    qkv, w = _inputs()
    wj = jnp.asarray(w)

    def obj(q, k, v):
        return (fn(q, k, v) * wj).sum()

    args = [jnp.asarray(a) for a in qkv]
    want = [np.asarray(jax.jit(fn)(*args))] + [
        np.asarray(g) for g in jax.jit(jax.grad(obj, argnums=(0, 1, 2)))(
            *args)]
    for i, ref in enumerate(want):
        _close(_assemble(port_results, mname, case, i, QKV,
                         MESHES[mname]), ref, ATTN_RTOL)


@pytest.mark.parametrize("mname,att", [(m, a) for m, atts in
                                       LLAMA_CASES.items() for a in atts])
def test_llama_loss_and_grads_match_jax(port_results, mname, att):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    params, tokens = _jax_llama_setup()
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32, attention=att)
    mesh = _jax_mesh(MESHES[mname])
    value, grads = jax.jit(jax.value_and_grad(functools.partial(
        jl.loss_fn, cfg=jcfg, mesh=mesh)))(params, jnp.asarray(tokens))
    losses = [r[mname]["llama_" + att][0] for r in port_results]
    for loss in losses:   # every rank holds the one loss
        assert loss == pytest.approx(float(value), rel=LOSS_RTOL)
    got = port_results[0][mname]["llama_" + att][1]
    want = [np.asarray(g) for g in jax.tree.leaves(grads)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, GRAD_RTOL)


def test_ring_and_ulysses_need_a_mesh_and_divisible_heads():
    """Without a mesh "ring" and "ulysses" raise, as in the JAX package;
    Ulysses refuses heads its axis does not divide, with the JAX
    message."""
    import torch

    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.parallel.ulysses import ulysses_attention
    for att in ("ring", "ulysses"):
        cfg = tl.LlamaConfig.tiny(n_layers=1, attention=att,
                                  dtype=torch.float32)
        with pytest.raises(ValueError, match="needs a mesh"):
            tl._make_attn_fn(cfg, None)

    class SpMesh:
        mesh_dim_names = ("sp",)

        @staticmethod
        def size(dim):
            return 4

    q = torch.zeros(1, 8, 6, 8)
    with pytest.raises(ValueError, match=r"heads \(6\) divisible by the "
                                         r"'sp' axis size \(4\)"):
        ulysses_attention(q, q, q, SpMesh())
