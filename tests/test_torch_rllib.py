"""The port's RLlib (``ray_tpu_torch.rllib``) against the JAX package's
(``ray_tpu.rllib``), on the CPU, in fp32.

Parameters are made by the JAX package and carried over with
``convert.from_jax``; observations and batches come from numpy seeds or
from the JAX package's own env runner, so both learners see the same
numbers. Where JAX draws randomness from a key, the test draws the same
noise from that key and hands it to the port's seam: the Gumbel noise of
``jax.random.categorical`` (which is argmax(logits + gumbel(key)) bit for
bit), the normal noise of ``sample_squashed``, the per-epoch permutations
of the PPO update and SAC's per-step key splits.

Tolerances: forward passes, samplers, GAE and V-trace within 1e-6 of the
output's largest value (fp32 sums in another order); one learner update
within 1e-5 of each leaf's largest value, the loss metric within 1e-5 of
itself (many Adam steps compound the sums' rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import env_runner as jrunner
from ray_tpu.rllib import impala as jimpala
from ray_tpu.rllib import learner as jlearner
from ray_tpu.rllib import module as jmod
from ray_tpu.rllib import sac as jsac
from ray_tpu_torch import convert
from ray_tpu_torch.rllib import dqn as tdqn
from ray_tpu_torch.rllib import env_runner as trunner
from ray_tpu_torch.rllib import impala as timpala
from ray_tpu_torch.rllib import learner as tlearner
from ray_tpu_torch.rllib import module as tmod
from ray_tpu_torch.rllib import sac as tsac
from ray_tpu_torch.train import param_leaves

torch.set_num_threads(1)

FWD_RTOL = 1e-6
UPDATE_RTOL = 1e-5
# greedy rollouts agree until a step whose top-2 logits lie this close
MARGIN = 1e-5


def ratio(got, want, rtol):
    """|got - want| over rtol times want's largest magnitude; <= 1 passes."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    return float(np.abs(got - want).max() / (rtol * scale))


def leaf_ratio(got_tree, want_tree):
    """The worst per-leaf ratio of two parameter trees at UPDATE_RTOL."""
    got = param_leaves(got_tree)
    want = [np.asarray(w) for w in jax.tree.leaves(want_tree)]
    assert len(got) == len(want)
    return max(ratio(g.numpy(), w, UPDATE_RTOL) for g, w in zip(got, want))


def discrete_params(seed=0, obs_dim=4, actions=2):
    jp = jmod.init_module(jax.random.PRNGKey(seed), obs_dim, actions)
    return jp, convert.from_jax(jp, device="cpu")


def sac_params(seed=0):
    jp = jmod.init_sac_module(jax.random.PRNGKey(seed), 3, 1)
    return jp, convert.from_jax(jp, device="cpu")


def jax_rollout(jp, T=16, B=8, seed=0, exploration="categorical",
                env="CartPole-v1", epsilon=None):
    runner = jrunner.EnvRunner(env, B, T, seed=seed,
                               exploration=exploration)
    runner.set_weights(jp, epsilon)
    return runner.sample()


def test_forward_q_forward_and_greedy_squashed_match_jax():
    rng = np.random.default_rng(0)
    jp, tp = discrete_params()
    obs = rng.normal(size=(32, 4)).astype(np.float32)
    jl, jv = jmod.forward(jp, jnp.asarray(obs))
    tl, tv = tmod.forward(tp, torch.from_numpy(obs))
    assert ratio(tl, jl, FWD_RTOL) <= 1 and ratio(tv, jv, FWD_RTOL) <= 1

    js, ts = sac_params()
    obs = rng.normal(size=(32, 3)).astype(np.float32)
    act = rng.uniform(-2, 2, size=(32, 1)).astype(np.float32)
    for k in ("q1", "q2"):
        jq = jmod.q_forward(js[k], jnp.asarray(obs), jnp.asarray(act))
        tq = tmod.q_forward(ts[k], torch.from_numpy(obs),
                            torch.from_numpy(act))
        assert ratio(tq, jq, FWD_RTOL) <= 1
    jg = jmod.greedy_squashed(js["actor"], jnp.asarray(obs), 2.0)
    tg = tmod.greedy_squashed(ts["actor"], torch.from_numpy(obs), 2.0)
    assert ratio(tg, jg, FWD_RTOL) <= 1


def test_sample_actions_with_jax_gumbel_noise_matches_jax():
    jp, tp = discrete_params(seed=1)
    obs = np.random.default_rng(1).normal(size=(256, 4)).astype(np.float32)
    # larger policy logits than the init's, so the samples vary
    jp = dict(jp, w_pi=jp["w_pi"] * 100)
    tp = dict(tp, w_pi=tp["w_pi"] * 100)
    key = jax.random.PRNGKey(7)
    ja, jlogp, jv = jmod.sample_actions(jp, jnp.asarray(obs), key)
    noise = jax.random.gumbel(key, (256, 2))
    ta, tlogp, tv = tmod.sample_actions(
        tp, torch.from_numpy(obs), noise=torch.from_numpy(np.array(noise)))
    assert 0 < int(np.asarray(ja).sum()) < 256
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ratio(tlogp, jlogp, FWD_RTOL) <= 1
    assert ratio(tv, jv, FWD_RTOL) <= 1


def test_sample_squashed_with_jax_normal_noise_matches_jax():
    js, ts = sac_params(seed=2)
    obs = np.random.default_rng(2).normal(size=(64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ja, jlogp = jmod.sample_squashed(js["actor"], jnp.asarray(obs), key, 2.0)
    eps = np.array(jax.random.normal(key, (64, 1)))
    ta, tlogp = tmod.sample_squashed(ts["actor"], torch.from_numpy(obs),
                                     action_scale=2.0,
                                     eps=torch.from_numpy(eps))
    assert ratio(ta, ja, FWD_RTOL) <= 1
    assert ratio(tlogp, jlogp, FWD_RTOL) <= 1


def test_samplers_draw_from_the_generator():
    _, tp = discrete_params()
    _, ts = sac_params()
    obs4 = torch.randn(64, 4, generator=torch.Generator().manual_seed(0))
    obs3 = obs4[:, :3]
    draws = []
    for seed in (5, 5, 6):
        g = torch.Generator().manual_seed(seed)
        a, _, _ = tmod.sample_actions(dict(tp, w_pi=tp["w_pi"] * 100),
                                      obs4, g)
        s, _ = tmod.sample_squashed(ts["actor"], obs3, g, 2.0)
        draws.append((a, s))
    assert torch.equal(draws[0][0], draws[1][0])
    assert torch.equal(draws[0][1], draws[1][1])
    assert not torch.equal(draws[0][1], draws[2][1])


def _trajectory(T=24, B=6, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        rewards=rng.normal(size=(T, B)).astype(np.float32),
        values=rng.normal(size=(T, B)).astype(np.float32),
        dones=rng.random((T, B)) < 0.15,
        last_value=rng.normal(size=B).astype(np.float32),
        behavior=np.log(rng.uniform(0.05, 1, (T, B))).astype(np.float32),
        target=np.log(rng.uniform(0.05, 1, (T, B))).astype(np.float32))


def test_compute_gae_matches_jax():
    tr = _trajectory()
    ja, jr = jlearner.compute_gae(
        jnp.asarray(tr["rewards"]), jnp.asarray(tr["values"]),
        jnp.asarray(tr["dones"]), jnp.asarray(tr["last_value"]),
        gamma=0.99, lam=0.95)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in tr.items()}
    ta, trr = tlearner.compute_gae(t["rewards"], t["values"], t["dones"],
                                   t["last_value"], gamma=0.99, lam=0.95)
    assert tr["dones"].any()
    assert ratio(ta, ja, FWD_RTOL) <= 1 and ratio(trr, jr, FWD_RTOL) <= 1


@pytest.mark.parametrize("rho_clip, c_clip", [(1.0, 1.0), (0.5, 2.0)])
def test_vtrace_matches_jax(rho_clip, c_clip):
    tr = _trajectory(seed=1)
    args = [tr[k] for k in ("behavior", "target", "values", "rewards",
                            "dones", "last_value")]
    jvs, jpg = jimpala.vtrace(*map(jnp.asarray, args), gamma=0.99,
                              rho_clip=rho_clip, c_clip=c_clip)
    tvs, tpg = timpala.vtrace(*map(torch.from_numpy, args), gamma=0.99,
                              rho_clip=rho_clip, c_clip=c_clip)
    rhos = np.exp(tr["target"] - tr["behavior"])
    assert (rhos > rho_clip).any() and (rhos < rho_clip).any()
    assert ratio(tvs, jvs, FWD_RTOL) <= 1 and ratio(tpg, jpg, FWD_RTOL) <= 1


def test_ppo_update_matches_jax():
    jp, tp = discrete_params(seed=4)
    batch = jax_rollout(jp, T=32, B=8, seed=4)
    assert batch["dones"].any()
    kw = dict(lr=1e-3, num_epochs=4, minibatches=4)
    jl = jlearner.PPOLearner(**kw)
    tl = tlearner.PPOLearner(**kw)
    key = jax.random.PRNGKey(9)
    N = batch["rewards"].size
    perms = [np.asarray(jax.random.permutation(k, N))
             for k in jax.random.split(key, kw["num_epochs"])]
    jnew, jm = jl.update(jp, batch, key)
    tnew, tm = tl.update(tp, batch, perms=perms)
    assert leaf_ratio(tnew, jnew) <= 1
    assert abs(tm["loss"] - jm["loss"]) <= UPDATE_RTOL * abs(jm["loss"])
    # the update made new tensors and left its inputs as they were
    assert leaf_ratio(tp, jp) == 0.0


def test_adam_clips_as_optax_does():
    """Both sides of optax's clip rule: a gradient under max_norm passes
    as it is, one over it becomes t / g * max_norm."""
    import optax
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=3).astype(np.float32)}
    for scale in (1e-3, 10.0):
        grads = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-2))
        state = opt.init(params)
        want = params
        got = convert.from_jax(params, device="cpu")
        adam = tlearner.Adam(1e-2, max_norm=1.0)
        adam.init(got)
        for _ in range(3):
            upd, state = opt.update(grads, state, want)
            want = optax.apply_updates(want, upd)
            got = adam.step(got, convert.from_jax(grads, device="cpu"))
        assert leaf_ratio(got, want) <= 1


def test_impala_update_matches_jax():
    jp, tp = discrete_params(seed=5)
    batch = jax_rollout(jp, T=32, B=8, seed=5)
    # a behaviour policy older than the learner's: rho away from 1
    batch["logp"] = batch["logp"] + np.random.default_rng(5).normal(
        0, 0.3, batch["logp"].shape).astype(np.float32)
    jl = jimpala.IMPALALearner(lr=1e-3)
    tl = timpala.IMPALALearner(lr=1e-3)
    jnew, jm = jl.update(jp, batch)
    tnew, tm = tl.update(tp, batch)
    assert leaf_ratio(tnew, jnew) <= 1
    for k in ("loss", "v_loss", "entropy"):
        assert abs(tm[k] - jm[k]) <= UPDATE_RTOL * abs(jm[k]), k


def _transitions(n=256, obs_dim=4, action_dim=None, seed=0):
    rng = np.random.default_rng(seed)
    actions = (rng.integers(0, 2, n).astype(np.int32) if action_dim is None
               else rng.uniform(-2, 2, (n, action_dim)).astype(np.float32))
    return {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "actions": actions,
            "rewards": rng.normal(size=n).astype(np.float32),
            "dones": rng.random(n) < 0.1,
            "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32)}


def test_dqn_update_with_a_target_net_matches_jax():
    jp, tp = discrete_params(seed=6)
    jt, tt = discrete_params(seed=7)
    batch = _transitions(seed=6)
    jl = jdqn.DQNLearner(lr=1e-3)
    tl = tdqn.DQNLearner(lr=1e-3)
    jnew, tnew = jp, tp
    for i in range(3):
        b = _transitions(seed=10 + i) if i else batch
        jnew, jm = jl.update(jnew, jt, b)
        tnew, tm = tl.update(tnew, tt, b)
    assert leaf_ratio(tnew, jnew) <= 1
    for k in ("loss", "td_abs_mean"):
        assert abs(tm[k] - jm[k]) <= UPDATE_RTOL * abs(jm[k]), k
    # the value head takes no gradient, as in JAX
    assert torch.equal(tnew["w_v"], tp["w_v"])


def test_huber_loss_is_optax_huber():
    import optax
    e = np.linspace(-3, 3, 61).astype(np.float32)
    np.testing.assert_allclose(tdqn.huber_loss(torch.from_numpy(e)).numpy(),
                               np.asarray(optax.huber_loss(e)), rtol=1e-7)


def test_sac_update_matches_jax():
    js, ts = sac_params(seed=8)
    n_steps, bsz = 4, 64
    stacks = [_transitions(bsz, 3, 1, seed=20 + i) for i in range(n_steps)]
    batches = {k: np.stack([s[k] for s in stacks]) for k in stacks[0]}
    key = jax.random.PRNGKey(11)
    # the JAX scan's noise: key, k1, k2 = split(key, 3) at every step
    eps_next, eps_actor, k = [], [], key
    for _ in range(n_steps):
        k, k1, k2 = jax.random.split(k, 3)
        eps_next.append(np.asarray(jax.random.normal(k1, (bsz, 1))))
        eps_actor.append(np.asarray(jax.random.normal(k2, (bsz, 1))))
    kw = dict(lr=1e-3, target_entropy=-1.0, action_scale=2.0)
    jl = jsac.SACLearner(**kw)
    tl = tsac.SACLearner(**kw)
    jnew, jm = jl.update(js, batches, key)
    tnew, tm = tl.update(ts, batches, noise={"next": np.stack(eps_next),
                                             "actor": np.stack(eps_actor)})
    assert leaf_ratio(tnew, jnew) <= 1
    assert leaf_ratio(tl.state["target"], jl.state["target"]) <= 1
    assert abs(float(tl.state["log_alpha"]) - float(
        jl.state["log_alpha"])) <= UPDATE_RTOL * abs(float(
            jl.state["log_alpha"]))
    for k in ("critic_loss", "actor_loss", "alpha"):
        assert abs(tm[k] - jm[k]) <= UPDATE_RTOL * abs(jm[k]), k


def test_greedy_rollout_matches_jax_runner():
    jp, tp = discrete_params(seed=12)
    # larger Q-heads, so the greedy action depends on the observation
    jp = dict(jp, w_pi=jp["w_pi"] * 100)
    tp = dict(tp, w_pi=tp["w_pi"] * 100)
    want = jax_rollout(jp, T=64, B=4, seed=12, exploration="epsilon_greedy",
                       epsilon=0.0)
    runner = trunner.EnvRunner("CartPole-v1", 4, 64, seed=12,
                               exploration="epsilon_greedy", device="cpu")
    runner.set_weights(tp, epsilon=0.0)
    got = runner.sample()
    # compare up to the first step whose top-2 Q-values lie within MARGIN
    logits, _ = jmod.forward(jp, jnp.asarray(want["obs"].reshape(-1, 4)))
    top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
    close = (top2[:, 1] - top2[:, 0]).reshape(64, 4).min(-1) < MARGIN
    steps = int(np.argmax(close)) if close.any() else 64
    assert steps >= 32, steps
    np.testing.assert_array_equal(got["obs"][:steps + 1],
                                  want["obs"][:steps + 1])
    for k in ("actions", "rewards", "dones"):
        np.testing.assert_array_equal(got[k][:steps], want[k][:steps])
    assert got["actions"].dtype == want["actions"].dtype == np.int32
    assert want["dones"][:steps].any()
    assert ratio(got["values"][:steps], want["values"][:steps],
                 FWD_RTOL) <= 1


def runner_params(handle):
    """The parameters an EnvRunner actor holds (local mode: the actor's
    instance lives in this process)."""
    backend = ray_tpu_torch.core.worker.global_worker.backend
    return backend.actors[handle.actor_id].instance.params


@pytest.fixture
def torch_rt():
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_runner_weights_do_not_move_with_the_learners(torch_rt):
    """Local mode stores values by reference: a runner must hold a
    snapshot, not the tensors the learner goes on to update."""
    from ray_tpu_torch.rllib import IMPALAConfig
    algo = IMPALAConfig(num_env_runners=2, num_envs_per_runner=4,
                        rollout_length=8, batches_per_iteration=2,
                        seed=0).build(device="cpu")
    try:
        algo.train()
        ray_tpu_torch.wait(list(algo._inflight), num_returns=2, timeout=60)
        held = [runner_params(r) for r in algo.runners]
        before = [tmod.snapshot(p) for p in held]
        learner_ptrs = {t.data_ptr() for t in param_leaves(algo.params)}
        for p in held:
            assert not learner_ptrs & {t.data_ptr() for t in param_leaves(p)}
        batch = ray_tpu_torch.get(next(iter(algo._inflight)), timeout=60)
        new, _ = algo.learner.update(algo.params, batch)
        for t in param_leaves(algo.params):     # an in-place step, too
            t.add_(1.0)
        for p, b in zip(held, before):
            for x, y in zip(param_leaves(p), param_leaves(b)):
                assert torch.equal(x, y)
        assert not torch.equal(new["w_pi"], before[0]["w_pi"])
    finally:
        algo.stop()


@pytest.mark.parametrize("config", ["PPOConfig", "IMPALAConfig", "DQNConfig",
                                    "SACConfig"])
def test_build_rejects_a_mesh_and_a_missing_card(config, monkeypatch):
    """PPO and IMPALA take a DeviceMesh and refuse anything else; DQN's
    and SAC's ``build`` take no mesh, as the JAX package's do."""
    import ray_tpu_torch.rllib as rl
    cfg = getattr(rl, config)()
    takes_mesh = config in ("PPOConfig", "IMPALAConfig")
    with pytest.raises(ValueError if takes_mesh else TypeError,
                       match="mesh"):
        cfg.build(device="cpu", mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cfg.build()


def test_chip_smoke_rl_phase_on_the_cpu():
    """chip_smoke.py's phase 11 at a few iterations on the CPU: the four
    algorithms through the runtime, the update timings and profile, the
    snapshot check and the oracle (CPU against CPU here)."""
    import dataclasses
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    cases = {}
    for name, (cfg, _, _) in chip_smoke.rl_cases().items():
        kw = {"DQN": dict(learning_starts=64),
              "SAC": dict(learning_starts=64, updates_per_iter=8)}
        cases[name] = (dataclasses.replace(cfg, **kw.get(name, {})), 2,
                       float("-inf"))
    out = chip_smoke.phase_rl(torch.device("cpu"), cases=cases)
    assert set(out) == {"PPO", "IMPALA", "DQN", "SAC"}
    assert not ray_tpu_torch.is_initialized()
