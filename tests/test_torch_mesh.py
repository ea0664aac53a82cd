"""The port's device mesh and collectives against the JAX package's, on the
CPU.

- ``MeshSpec``: resolve, fill and errors, case by case against
  ``ray_tpu.parallel.mesh.MeshSpec``; the rank layout (dcn axes major)
  against the device layout of the JAX ``build_mesh``; placements of a
  spec.
- The collectives, on 4 gloo ranks of ``TorchTrainer`` (mesh dp 2 x tp 2),
  against ``ray_tpu.parallel.collectives`` under ``shard_map`` on 4 of
  the 8 virtual CPU devices, same mesh shape: each op's output on every
  rank, and the gradient it passes back for a per-rank cotangent (its
  transpose, as JAX differentiates it).
- ``flash_attention_sharded`` on the same ranks (each rank its batch and
  head shard, the plain versions on the CPU) against the JAX package's
  ``flash_attention_sharded`` on its mesh, the Pallas kernels in
  interpret mode: output and gradients.
"""

import functools

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import train
from ray_tpu_torch.parallel import mesh as tmesh

# -------------------------------------------------------------- MeshSpec

RESOLVE_CASES = [
    (dict(fsdp=-1, tp=2), 8), (dict(dp=2, fsdp=2, tp=2), 8),
    (dict(tp=3), 8), (dict(fsdp=-1, tp=-1), 8), (dict(dp=0), 8),
    (dict(dp=-1, dcn_dp=2), 8), (dict(fsdp=2, dcn_dp=2, tp=2), 8),
    (dict(dp=-1, dcn_dp=3), 8), (dict(dp=2, dcn_pp=0), 4),
    (dict(fsdp=-1, tp=3), 8), (dict(), 1), (dict(pp=2, sp=2, tp=-1), 16),
]


@pytest.mark.parametrize("kw,n", RESOLVE_CASES)
def test_meshspec_resolve_matches_jax(kw, n):
    from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec

    def outcome(cls):
        try:
            s = cls(**kw).resolve(n)
            return ("ok", s.degrees(), s.size, s.num_slices)
        except ValueError as e:
            return ("error", str(e))

    assert outcome(tmesh.MeshSpec) == outcome(JMeshSpec)


@pytest.mark.parametrize("kw,n", [(dict(fsdp=2, tp=2), 4),
                                  (dict(fsdp=-1, dcn_dp=2, tp=2), 8),
                                  (dict(dp=-1, dcn_pp=2), 8)])
def test_rank_layout_matches_jax_device_layout(kw, n):
    import jax

    from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec, build_mesh
    devices = jax.devices()[:n]
    jm = build_mesh(JMeshSpec(**kw), devices=devices)
    ids = np.vectorize(lambda d: devices.index(d))(jm.devices)
    layout = tmesh._rank_layout(tmesh.MeshSpec(**kw).resolve(n), None)
    assert layout.tolist() == ids.tolist()


def test_group_by_slice_uses_node_ids():
    ids = ["b", "a", "b", "a"]
    assert tmesh._group_by_slice(ids, 2) == [[1, 3], [0, 2]]
    assert tmesh._group_by_slice(["n"] * 4, 2) == [[0, 1], [2, 3]]
    with pytest.warns(UserWarning, match="contiguous"):
        assert tmesh._group_by_slice(["a", "b", "c", "c"], 2) == \
            [[0, 1], [2, 3]]


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    class FakeMesh:
        pass

    pl = tmesh.placements(FakeMesh(), tmesh.P(("dp", "fsdp"), None, "tp"))
    assert pl == [Replicate(), Shard(0), Shard(0), Replicate(), Shard(2)]
    with pytest.raises(ValueError, match="mesh order"):
        tmesh.placements(FakeMesh(), tmesh.P(("fsdp", "dp")))
    with pytest.raises(ValueError, match="unknown mesh axis"):
        tmesh.placements(FakeMesh(), tmesh.P("x"))


# ----------------------------------------------------------- collectives

#: (name, op, axis, kwargs); x per rank is [4, 3]
COLLECTIVES = [
    ("psum_tp", "allreduce", "tp", {"op": "sum"}),
    ("pmean_dp", "allreduce", "dp", {"op": "mean"}),
    ("pmax_all", "allreduce", ("dp", "tp"), {"op": "max"}),
    ("pmin_tp", "allreduce", "tp", {"op": "min"}),
    ("gather_tp", "allgather", "tp", {"axis": 0}),
    ("gather_dp_stacked", "allgather", "dp", {"axis": 1, "tiled": False}),
    ("scatter_tp", "reducescatter", "tp", {"axis": 0}),
    ("bcast_tp", "broadcast", "tp", {"root": 1}),
    ("a2a_tp", "alltoall", "tp", {"split_axis": 0, "concat_axis": 1}),
    ("shift_all", "ppermute_shift", ("dp", "tp"), {"shift": 1}),
]
NO_GRAD = ("pmax_all", "pmin_tp")
X_SHAPE = (16, 3)                # 4 ranks x [4, 3]
ATTN = (4, 16, 4, 8)             # B, L, H, D: B over dp, H over tp


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, _system_config={
        "object_store_memory_bytes": 128 * 1024 * 1024,
        "worker_pool_prestart": 4,
    })
    yield rt
    rt.shutdown()


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(X_SHAPE).astype(np.float32)
    qkv = [rng.standard_normal(ATTN).astype(np.float32) for _ in range(4)]
    return x, qkv


def _make_loop():
    def loop(cfg):
        import torch
        import torch.distributed as dist

        from ray_tpu_torch import train
        from ray_tpu_torch.ops.flash_attention import flash_attention_sharded
        from ray_tpu_torch.parallel import collectives
        from ray_tpu_torch.parallel.mesh import shard_constraint
        from ray_tpu_torch.train.backend import process_index

        torch.set_num_threads(1)
        mesh = train.get_context().global_mesh()
        rank = dist.get_rank()
        assert process_index() == rank
        # a replicated tensor laid out over (dp, tp), then back
        whole = torch.arange(16.).reshape(8, 2)
        rows = shard_constraint(whole, mesh, ("dp", "tp"))
        out = {"rows": (rows.to_local().numpy(),
                        shard_constraint(rows, mesh).to_local().numpy())}
        x_all = torch.tensor(cfg["x"])
        for name, op, axis, kw in cfg["cases"]:
            x = x_all[4 * rank:4 * rank + 4].clone().requires_grad_()
            y = getattr(collectives, op)(x, mesh, axis, **kw)
            grad = None
            if name not in cfg["no_grad"]:
                rng = torch.Generator().manual_seed(rank)
                c = torch.randn(y.shape, generator=rng)
                (y * c).sum().backward()
                grad = x.grad.numpy()
            out[name] = (y.detach().numpy(), grad)
        # flash per shard: batch rows over dp, heads over tp
        dp, tp = mesh.get_coordinate()[1], mesh.get_coordinate()[4]
        B, L, H, D = cfg["qkv"][0].shape
        b, h = B // 2, H // 2
        q, k, v, do = (torch.tensor(a)[dp * b:(dp + 1) * b, :,
                                       tp * h:(tp + 1) * h]
                       .clone().requires_grad_() for a in cfg["qkv"])
        o = flash_attention_sharded(q, k, v, mesh)
        (o * do.detach()).sum().backward()
        out["flash"] = [t.detach().numpy() for t in (o, q.grad, k.grad,
                                                     v.grad)]
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, out)
        train.report({"ranks": gathered})
    return loop


@pytest.fixture(scope="module")
def port_results(cluster, tmp_path_factory):
    x, qkv = _inputs()
    result = train.TorchTrainer(
        _make_loop(),
        train_loop_config={"x": x, "qkv": qkv, "cases": COLLECTIVES,
                           "no_grad": NO_GRAD},
        scaling_config=train.ScalingConfig(
            num_workers=4, mesh=tmesh.MeshSpec(dp=2, tp=2)),
        run_config=train.RunConfig(
            storage_path=str(tmp_path_factory.mktemp("mesh")))).fit()
    return result.metrics["ranks"]


def _jax_mesh():
    import jax

    from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec, build_mesh
    return build_mesh(JMeshSpec(dp=2, tp=2), devices=jax.devices()[:4])


@pytest.mark.parametrize("case", COLLECTIVES, ids=[c[0] for c in COLLECTIVES])
def test_collective_matches_jax(port_results, case):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from ray_tpu.parallel import collectives as jc
    from ray_tpu.parallel.mesh import shard_map_compat
    name, op, axis, kw = case
    x, _ = _inputs()
    spec = JP(("dp", "tp"))
    fn = shard_map_compat(lambda b: getattr(jc, op)(b, axis, **kw),
                          mesh=_jax_mesh(), in_specs=(spec,), out_specs=spec)
    if name in NO_GRAD:     # JAX has no derivative of pmax/pmin either
        y, vjp = fn(jnp.asarray(x)), None
    else:
        y, vjp = jax.vjp(fn, jnp.asarray(x))
    per = y.shape[0] // 4
    for rank, got in enumerate(port_results):
        g_y, g_dx = got[name]
        np.testing.assert_allclose(g_y, np.asarray(y[rank * per:
                                                     (rank + 1) * per]),
                                   rtol=1e-6, atol=1e-6)
    if name in NO_GRAD:
        return
    import torch
    cots = []
    for rank in range(4):
        g = torch.Generator().manual_seed(rank)
        cots.append(torch.randn(port_results[rank][name][0].shape,
                                generator=g).numpy())
    (dx,) = vjp(jnp.asarray(np.concatenate(cots)))
    for rank, got in enumerate(port_results):
        np.testing.assert_allclose(got[name][1],
                                   np.asarray(dx[4 * rank:4 * rank + 4]),
                                   rtol=1e-5, atol=1e-5)


def test_flash_attention_sharded_matches_jax(port_results, monkeypatch):
    """The JAX package's flash_attention_sharded runs the Pallas kernels
    per shard; here in interpret mode at blocks of the test's length."""
    import importlib

    import jax
    import jax.numpy as jnp
    jfa = importlib.import_module("ray_tpu.ops.flash_attention")
    orig = jfa.flash_attention

    def interpreted(q, k, v, causal=True, blk_q=None, blk_k=None, **_):
        L = q.shape[1]
        return orig(q, k, v, causal=causal, blk_q=L, blk_k=L, interpret=True)

    monkeypatch.setattr(jfa, "flash_attention", interpreted)
    _, qkv = _inputs()
    q, k, v, do = (jnp.asarray(a) for a in qkv)
    mesh = _jax_mesh()
    o, vjp = jax.vjp(functools.partial(jfa.flash_attention_sharded,
                                       mesh=mesh), q, k, v)
    want = [np.asarray(t) for t in (o, *vjp(do))]
    B, _, H, _ = q.shape
    for rank, got in enumerate(port_results):
        dp, tp = divmod(rank, 2)
        for g, w in zip(got["flash"], want):
            w = w[dp * B // 2:(dp + 1) * B // 2, :,
                  tp * H // 2:(tp + 1) * H // 2]
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_shard_constraint_lays_rows_out_in_rank_order(port_results):
    whole = np.arange(16.).reshape(8, 2)
    for rank, got in enumerate(port_results):
        rows, back = got["rows"]
        np.testing.assert_array_equal(rows, whole[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(back, whole)


def test_flash_attention_sharded_refuses_sp_and_dtensors():
    import torch

    from ray_tpu_torch.ops.flash_attention import (check_shard_geometry,
                                                   flash_attention_sharded)

    class SpMesh:
        def size(self, i):
            return 2 if tmesh.AXIS_ORDER[i] == "sp" else 1

    q = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match="sequence"):
        flash_attention_sharded(q, q, q, SpMesh())
    with pytest.raises(ValueError, match="shape"):
        check_shard_geometry(q, q[:, :4], q)
