"""The prefetching fsdp step and the sharded Adafactor of the port against
the JAX package's, on the CPU, through ``TorchTrainer`` over gloo ranks
(the helpers of tests/test_torch_sharded_train.py): ``fsdp_overlap``
(``overlap_scan``: each layer's gather issued before the previous layer's
compute) against the plain sharded step and JAX's ``_loss_overlap`` on dp
2 x fsdp 2; Adafactor on fsdp 2 at widths whose leaves factor (dims >= 128
after sharding) against ``optax.adafactor``; the equal-shard rule of
``shard_batch``.
"""

import dataclasses

import numpy as np
import pytest

from ray_tpu_torch import train
from ray_tpu_torch.parallel.mesh import MeshSpec
from test_torch_sharded_train import (LOSS_RTOL, _close, _fit,  # noqa: F401
                                      _jax_run, _jax_setup, _port_cfg,
                                      cluster)

#: widths at which Adafactor factors every matrix (>= 128 after fsdp 2)
FACTORED = dict(dim=256, ffn_dim=512, n_heads=4, n_kv_heads=2)


def test_fsdp_overlap_matches_plain_and_jax(cluster, tmp_path):
    spec = dict(dp=2, fsdp=2)
    jcfg, params, tokens = _jax_setup()
    want = _jax_run(spec, dataclasses.replace(jcfg, fsdp_overlap=True),
                    params, tokens, ("sgd",))
    plain = _fit(spec, _port_cfg(params, tokens, grads=True),
                 tmp_path / "plain")
    got = _fit(spec, _port_cfg(params, tokens, {"fsdp_overlap": True},
                               grads=True, optimizers=("sgd",)),
               tmp_path / "overlap")
    assert got["loss"] == pytest.approx(plain["loss"], rel=1e-6)
    _close(got["grads"], plain["grads"], rtol=1e-6)
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    _close(got["grads"], want["grads"])
    _close(got["sgd"]["params"], want["sgd"]["params"])


def test_sharded_adafactor_matches_optax(cluster, tmp_path):
    """fsdp 2 at widths that factor: the row and column means and the
    RMS of the update and of each parameter reduce over the fsdp shards
    (a per-shard bug shows in every factored leaf)."""
    from ray_tpu_torch.train.optim import factored_dims
    spec = dict(fsdp=2)
    jcfg, params, tokens = _jax_setup(FACTORED)
    shapes = [tuple(np.shape(x)) for x in
              __import__("jax").tree.leaves(params)]
    factored = [s for s in shapes if factored_dims(s) is not None]
    assert len(factored) >= 7, shapes        # embed and every matrix
    want = _jax_run(spec, jcfg, params, tokens, ("adafactor",))
    got = _fit(spec, _port_cfg(params, tokens, FACTORED,
                               optimizers=("adafactor",)), tmp_path)
    for (l, n), (jl_, jn) in zip(got["adafactor"]["metrics"],
                                 want["adafactor"]["metrics"]):
        assert l == pytest.approx(jl_, rel=LOSS_RTOL)
        assert n == pytest.approx(jn, rel=1e-4)
    _close(got["adafactor"]["params"], want["adafactor"]["params"])


def test_shard_batch_needs_equal_shards(cluster, tmp_path):
    def loop():
        import torch

        from ray_tpu_torch import train
        mesh = train.get_context().global_mesh()
        try:
            train.shard_batch(torch.zeros(3, 4, dtype=torch.long), mesh)
        except ValueError as e:
            train.report({"error": str(e)})

    result = train.TorchTrainer(
        loop, scaling_config=train.ScalingConfig(
            num_workers=2, mesh=MeshSpec(dp=-1)),
        run_config=train.RunConfig(storage_path=str(tmp_path))).fit()
    assert "equal shards" in result.metrics["error"]
