"""The port's behavior cloning (``ray_tpu_torch.rllib.bc``) against the JAX
package's, on the CPU, in fp32.

One ``BCLearner`` update on parameters carried over with
``convert.from_jax`` must agree with the JAX learner's within 1e-5 of
each leaf's largest value (tests/test_torch_rllib.py's limit: Adam steps
compound fp32 sums taken in another order); ``record_dataset`` must turn
the same runner batches into the same rows, with the same dtypes, in
both packages; and BC must clone a PPO teacher to tests/test_rllib.py's
gate through the port's runtime and datasets.
"""

import gc

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.rllib import bc as jbc
from ray_tpu.rllib import module as jmod
from ray_tpu_torch import convert
from ray_tpu_torch.rllib import bc as tbc
from ray_tpu_torch.rllib.module import snapshot
from ray_tpu_torch.train import param_leaves

torch.set_num_threads(1)

UPDATE_RTOL = 1e-5


def leaf_ratio(got_tree, want_tree):
    """The worst |got - want| over UPDATE_RTOL times want's largest
    magnitude, over the leaves; at most 1 passes."""
    got = param_leaves(got_tree)
    want = [np.asarray(w) for w in jax.tree.leaves(want_tree)]
    assert len(got) == len(want)
    return max(float(np.abs(g.numpy() - w).max()
                     / (UPDATE_RTOL * max(np.abs(w).max(), 1e-30)))
               for g, w in zip(got, want))


def bc_batch(seed, n=512):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "action": rng.integers(0, 2, n).astype(np.int32)}


def test_bc_update_matches_jax():
    jp = jmod.init_module(jax.random.PRNGKey(3), 4, 2)
    tp = convert.from_jax(jp, device="cpu")
    jl = jbc.BCLearner(lr=1e-3)
    tl = tbc.BCLearner(lr=1e-3)
    jl.init(jp)
    tl.init(tp)
    for step in range(3):
        batch = bc_batch(step)
        before = snapshot(tp)
        jp, jm = jl.update(jp, batch)
        tnew, tm = tl.update(tp, batch)
        assert abs(tm["bc_loss"] - jm["bc_loss"]) \
            <= UPDATE_RTOL * abs(jm["bc_loss"])
        # the update made new tensors and left its inputs as they were
        for a, b in zip(param_leaves(tp), param_leaves(before)):
            assert torch.equal(a, b)
        assert not torch.equal(tnew["w_pi"], tp["w_pi"])
        tp = tnew
    assert leaf_ratio(tp, jp) <= 1
    # the value head takes no gradient from the policy's cross-entropy
    assert torch.equal(tp["w_v"], convert.from_jax(jp, device="cpu")["w_v"])


class FixedRunner:
    """A runner whose batches come from a seed: [T, B] actions and
    [T, B, 4] observations, as the env runners return them."""

    def __init__(self, seed, T=32, B=16):
        self.rng = np.random.default_rng(seed)
        self.T, self.B = T, B

    def set_weights(self, params, epsilon=None):
        return True

    def sample(self):
        return {"obs": self.rng.normal(size=(self.T, self.B, 4)),
                "actions": self.rng.integers(0, 2, (self.T, self.B))}


class StubAlgo:
    def __init__(self, rt, n_runners=2):
        cls = rt.remote(FixedRunner)
        self.runners = [cls.remote(10 + i) for i in range(n_runners)]

    def _broadcast_weights(self):
        pass


@pytest.fixture
def runtimes():
    # no cyclic collection inside the JAX local-mode store's plain lock
    # (it deadlocks; tests/test_torch_data.py pauses it alike)
    gc.disable()
    ray_tpu.init(local_mode=True, num_cpus=4)
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()
        gc.enable()
        gc.collect()


@pytest.mark.parametrize("num_samples", [1000, 2048])
def test_record_dataset_rows_match_jax(runtimes, num_samples):
    want = jbc.record_dataset(StubAlgo(ray_tpu), num_samples)
    got = tbc.record_dataset(StubAlgo(ray_tpu_torch), num_samples)
    assert got.count() == want.count() == num_samples
    wb = list(want.iter_batches(batch_size=300))
    gb = list(got.iter_batches(batch_size=300))
    assert len(gb) == len(wb)
    for g, w in zip(gb, wb):
        assert g.keys() == w.keys() == {"obs", "action"}
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert gb[0]["obs"].dtype == np.float32 and gb[0]["obs"].shape[1] == 4
    assert gb[0]["action"].dtype == np.int32
    # the rows are the runners' own, in the order their batches came
    first = FixedRunner(10).sample()
    np.testing.assert_array_equal(gb[0]["obs"][:300],
                                  first["obs"].reshape(-1, 4)[:300]
                                  .astype(np.float32))


def test_bc_clones_ppo_policy_from_dataset():
    """tests/test_rllib.py's BC gate through the port on the CPU, as
    chip_smoke.py's phase 12c runs it on the card: a PPO teacher to its
    gate, 8192 recorded rows, BC to 100 within 15 iterations, no port
    kernel launched, one update against the CPU (CPU against CPU
    here)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    out = chip_smoke.phase_bc(torch.device("cpu"))
    assert out["teacher_best"] >= 100.0 and out["bc_best"] >= 100.0, out
    assert out["bc_iterations"] <= 15
    assert not ray_tpu_torch.is_initialized()


def test_bc_build_rejects_a_mesh_a_missing_card_and_no_dataset(
        monkeypatch):
    cfg = tbc.BCConfig(dataset=object())
    # a mesh must be a DeviceMesh (build(mesh=) takes one since the
    # learners' mesh path was ported)
    with pytest.raises(ValueError, match="DeviceMesh"):
        cfg.build(device="cpu", mesh=object())
    with pytest.raises(ValueError, match="dataset"):
        tbc.BCConfig().build(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cfg.build()
