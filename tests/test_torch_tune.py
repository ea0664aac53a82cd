"""The port's Tune (``ray_tpu_torch.tune``) against the JAX package's
(``ray_tpu.tune``).

Variant generation and the searchers must give the same variants for the
same seed; the schedulers (FIFO, ASHA, PBT, the median rule) the same
decisions on the same replayed sequence of results, PBT's exploits and
explored configs included. Then tests/test_tune.py's programs run through
the port's local-mode runtime and must reach that file's own gates.
"""

import math
import random
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu import tune as jtune
from ray_tpu.tune import search as jsearch
from ray_tpu.tune import trial as jtrial
from ray_tpu_torch import tune
from ray_tpu_torch.tune import search as tsearch
from ray_tpu_torch.tune import trial as ttrial


def spaces(t):
    """Search spaces built with package ``t``'s constructors."""
    return [
        {"a": t.grid_search([1, 2, 3]), "b": t.uniform(0.0, 1.0),
         "c": "const"},
        {"lr": t.loguniform(1e-4, 1e-1), "n": t.randint(1, 10),
         "act": t.choice(["relu", "tanh", "gelu"]),
         "g": {"grid_search": [0.5, 0.9]}},
        {"x": t.grid_search([1, 2]), "y": t.grid_search(["p", "q"]),
         "z": t.uniform(-5.0, 5.0)},
    ]


GRID_POINTS = [3, 2, 4]         # grid cross-product size of each space


@pytest.mark.parametrize("space", range(3))
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_generate_variants_match_jax(space, seed):
    for num_samples in (1, 3):
        want = jsearch.generate_variants(spaces(jtune)[space], num_samples,
                                         seed=seed)
        got = tsearch.generate_variants(spaces(tune)[space], num_samples,
                                        seed=seed)
        assert got == want
        assert len(got) == num_samples * GRID_POINTS[space]
    # PBT's explore draws one key with the caller's generator
    for key in ("a", "b", "lr", "n", "act", "z"):
        for space_j, space_t in zip(spaces(jtune), spaces(tune)):
            if key in space_j:
                assert tsearch.resample_key(space_t, key, random.Random(3)) \
                    == jsearch.resample_key(space_j, key, random.Random(3))


def _suggestions(searcher, space, feedback):
    searcher.set_search_properties("loss", "min", space)
    out = []
    for i in range(40):
        cfg = searcher.suggest(f"s{i}")
        if cfg is None:
            break
        out.append(cfg)
        if feedback:
            searcher.on_trial_complete(
                f"s{i}", {"loss": (cfg["x"] - 2.0) ** 2 + cfg.get("k", 0)})
    return out


@pytest.mark.parametrize("kind", ["basic", "hyperopt"])
def test_searchers_suggest_as_jax(kind):
    def make(t):
        if kind == "basic":
            return (t.BasicVariantSearcher(num_samples=3, seed=5),
                    {"x": t.grid_search([1.0, 2.0]), "k": t.uniform(0, 1)})
        return (t.HyperOptLikeSearcher(num_samples=24, warmup=6, seed=7),
                {"x": t.uniform(-5.0, 5.0), "k": t.randint(0, 3)})
    want = _suggestions(*make(jtune), feedback=kind == "hyperopt")
    got = _suggestions(*make(tune), feedback=kind == "hyperopt")
    assert got == want
    assert len(got) == (6 if kind == "basic" else 24)


def _replay(trial_mod, scheduler):
    """Feed one fixed sequence of results to ``scheduler``, doing what
    the controller does between them: -> the decisions and exploits."""
    scheduler.set_experiment("score", "max", {"slope": None})
    slopes = [4.0, 3.0, 2.0, 1.0, 0.4, 0.3, 0.2, 0.1]
    trials = [trial_mod.Trial(trial_id=f"t{i:04d}", config={"slope": s})
              for i, s in enumerate(slopes)]
    live = list(trials)
    log = []
    rng = random.Random(11)     # the order in which results arrive
    it = {tr.trial_id: 0 for tr in trials}
    while live:
        tr = rng.choice(live)
        it[tr.trial_id] += 1
        i = it[tr.trial_id]
        result = {"score": tr.config["slope"] * i * (1 + 0.1 * math.sin(i)),
                  "training_iteration": i}
        if i % 2 == 0:
            tr.checkpoint_path = f"{tr.trial_id}/ckpt_{i}"
        tr.last_result = result
        tr.results.append(result)
        decision = scheduler.on_result(tr, result, trials)
        exploit = getattr(tr, "_pbt_exploit", None)
        if exploit is not None:
            del tr._pbt_exploit
            tr.config = exploit["config"]
            tr.checkpoint_path = exploit["checkpoint_path"]
        log.append((tr.trial_id, i, decision, exploit))
        if decision == "STOP" or i >= 16:
            live.remove(tr)
            scheduler.on_trial_complete(tr.trial_id)
    return log


SCHEDULERS = {
    "fifo": lambda t: t.FIFOScheduler(),
    "asha": lambda t: t.ASHAScheduler(max_t=16, grace_period=2,
                                      reduction_factor=2),
    "pbt": lambda t: t.PopulationBasedTraining(
        perturbation_interval=2, quantile_fraction=0.25,
        hyperparam_mutations={"slope": t.uniform(0.1, 5.0)},
        resample_probability=0.3, seed=0),
    "median": lambda t: t.MedianStoppingRule(grace_period=2,
                                             min_samples_required=2),
}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_schedulers_decide_as_jax(name):
    want = _replay(jtrial, SCHEDULERS[name](jtune))
    got = _replay(ttrial, SCHEDULERS[name](tune))
    assert got == want
    decisions = {d for _, _, d, _ in got}
    exploits = [e for *_, e in got if e is not None]
    if name == "fifo":
        assert decisions == {"CONTINUE"} and not exploits
    if name in ("asha", "median"):
        assert "STOP" in decisions
    if name == "pbt":
        assert len(exploits) >= 2


# ------------------------------------------- tests/test_tune.py's programs


@pytest.fixture
def torch_rt():
    ray_tpu_torch.init(local_mode=True, num_cpus=8)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def fifo_runs_all_trials(tmp):
    def trainable(cfg):
        for _ in range(3):
            tune.report({"score": cfg["x"] * 2})

    grid = tune.Tuner(
        trainable, param_space={"x": tune.grid_search([1, 2, 3, 4])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=tune.TuneRunConfig(storage_path=str(tmp))).fit()
    assert len(grid.trials) == 4
    assert all(t.status == tune.TrialStatus.TERMINATED for t in grid.trials)
    best = grid.get_best_result()
    assert best.config["x"] == 4 and best.last_result["score"] == 8
    rows = grid.get_dataframe()
    assert len(rows) == 4 and all("config/x" in r for r in rows)
    return sorted((t.config["x"], t.iteration) for t in grid.trials)


def trial_error_surfaces(tmp):
    def flaky(cfg):
        tune.report({"score": 1})
        raise RuntimeError("trial-boom")

    grid = tune.Tuner(
        flaky, param_space={"x": 1},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=tune.TuneRunConfig(storage_path=str(tmp))).fit()
    assert len(grid.errors) == 1
    assert "trial-boom" in grid.trials[0].error


def asha_stops_bad_trials_early(tmp):
    MAX_T = 32

    def trainable(cfg):
        for i in range(MAX_T):
            tune.report({"score": cfg["slope"] * (i + 1)})

    grid = tune.Tuner(
        trainable,
        param_space={"slope": tune.grid_search(
            [4.0, 3.0, 2.0, 1.0, 0.4, 0.3, 0.2, 0.1])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max",
            scheduler=tune.ASHAScheduler(
                max_t=MAX_T, grace_period=2, reduction_factor=2),
            max_concurrent_trials=2),
        run_config=tune.TuneRunConfig(storage_path=str(tmp))).fit()
    iters = {t.config["slope"]: t.iteration for t in grid.trials}
    assert sum(iters.values()) < 8 * MAX_T * 0.8, iters
    assert iters[4.0] >= MAX_T - 1, iters
    assert grid.get_best_result().config["slope"] == 4.0


def pbt_rescues_stuck_trials(tmp):
    STEPS = 24

    def trainable(cfg):
        state = tune.get_checkpoint()
        x = state["x"] if state else 5.0
        lr = cfg["lr"]
        start = state["step"] if state else 0
        for step in range(start, STEPS):
            x = x - lr * 2 * x  # GD on f(x) = x^2
            tune.report({"loss": x * x},
                        checkpoint={"x": x, "step": step + 1})

    grid = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([0.3, 0.3, 1.99, 1.99])},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min",
            scheduler=tune.PopulationBasedTraining(
                perturbation_interval=4,
                hyperparam_mutations={"lr": tune.uniform(0.1, 0.5)},
                quantile_fraction=0.5, seed=0),
            max_concurrent_trials=4),
        run_config=tune.TuneRunConfig(storage_path=str(tmp))).fit()
    losses = sorted(t.last_result["loss"] for t in grid.trials)
    assert losses[-1] < 1.0, f"PBT failed to rescue stuck trials: {losses}"


def experiment_restore_resumes(tmp):
    def trainable(cfg):
        state = tune.get_checkpoint()
        start = state["step"] if state else 0
        if start == 0 and cfg["x"] == 2:
            tune.report({"score": 0}, checkpoint={"step": 1})
            raise RuntimeError("mid-crash")
        for step in range(start, 3):
            tune.report({"score": cfg["x"] * 10 + step},
                        checkpoint={"step": step + 1})

    grid = tune.Tuner(
        trainable, param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=tune.TuneRunConfig(storage_path=str(tmp),
                                      name="exp1")).fit()
    assert len(grid.errors) == 1
    grid2 = tune.Tuner.restore(grid.storage_path, trainable).fit()
    assert not grid2.errors
    by_x = {t.config["x"]: t for t in grid2.trials}
    assert by_x[2].last_result["score"] == 22
    assert by_x[2].status == tune.TrialStatus.TERMINATED
    assert by_x[1].last_result["score"] == 12


def sequential_searcher_feedback(tmp):
    def trainable(config):
        tune.report({"loss": (config["x"] - 2.0) ** 2})

    searcher = tune.HyperOptLikeSearcher(num_samples=24, warmup=6, seed=7)
    results = tune.Tuner(
        trainable, param_space={"x": tune.uniform(-5.0, 5.0)},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    search_alg=searcher,
                                    max_concurrent_trials=6),
        run_config=tune.TuneRunConfig(storage_path=str(tmp))).fit()
    assert len(results.trials) == 24
    assert abs(results.get_best_result().config["x"] - 2.0) < 1.0
    assert len(searcher._observed) == 24


def median_rule_prunes(tmp):
    MAX_T = 24

    def trainable(cfg):
        for i in range(MAX_T):
            tune.report({"score": cfg["slope"] * (i + 1)})

    grid = tune.Tuner(
        trainable,
        param_space={"slope": tune.grid_search(
            [4.0, 3.0, 2.0, 1.0, 0.4, 0.3, 0.2, 0.1])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max",
            scheduler=tune.MedianStoppingRule(grace_period=2,
                                              min_samples_required=2),
            max_concurrent_trials=2),
        run_config=tune.TuneRunConfig(storage_path=str(tmp))).fit()
    iters = {t.config["slope"]: t.iteration for t in grid.trials}
    assert sum(iters.values()) < 8 * MAX_T * 0.8, iters
    assert iters[4.0] >= MAX_T - 1 and iters[0.1] < MAX_T, iters


PROGRAMS = [fifo_runs_all_trials, trial_error_surfaces,
            asha_stops_bad_trials_early, pbt_rescues_stuck_trials,
            experiment_restore_resumes, sequential_searcher_feedback,
            median_rule_prunes]


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__)
def test_tune_program_reaches_its_gate_through_the_port(program, torch_rt,
                                                        tmp_path):
    program(tmp_path)
    # every trial's function thread has unwound
    assert not [t for t in threading.enumerate()
                if t.name == "tune-trial-fn" and t.is_alive()]


@pytest.mark.parametrize("program", [median_rule_prunes,
                                     asha_stops_bad_trials_early],
                         ids=lambda p: p.__name__)
def test_fit_returns_after_the_stopped_trials_unwind(program, torch_rt,
                                                     tmp_path, monkeypatch):
    """Under the suite's load, ``median_rule_prunes`` found a pruned
    trial's function thread still alive after ``fit()``: the controller
    only sends ``stop()``, and the thread, parked on its full result queue,
    unwinds when the trial's actor thread gets to run that call. Each
    ``stop()`` is paced here by 0.3 s, as a loaded actor thread would be;
    ``fit()`` must still return only once every stop has answered."""
    stop = ttrial.TrialRunner.stop

    def paced_stop(self):
        time.sleep(0.3)
        return stop(self)

    monkeypatch.setattr(ttrial.TrialRunner, "stop", paced_stop)
    program(tmp_path)
    assert not [t for t in threading.enumerate()
                if t.name == "tune-trial-fn" and t.is_alive()]


def test_stopped_trial_waits_for_its_function():
    """``TrialRunner.stop`` returns once the function's thread has left
    torch code: it unwinds at its next report."""
    gate = threading.Event()

    def fn(cfg):
        while True:
            gate.wait(0.05)
            tune.report({"x": 1})

    runner = ttrial.TrialRunner(fn, {}, "unused")
    assert runner.next_result()["x"] == 1
    assert runner.stop()
    assert not runner._thread.is_alive()


def test_trials_ask_for_the_card_and_run_in_local_mode(torch_rt, tmp_path):
    """A trial's ``{"GPU": 1}`` is bookkeeping in local mode, as the
    reference's is: trials run, the card is not reserved."""
    def trainable(cfg):
        tune.report({"score": cfg["x"]})

    grid = tune.Tuner(
        trainable, param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    max_concurrent_trials=2),
        run_config=tune.TuneRunConfig(
            storage_path=str(tmp_path),
            resources_per_trial={"CPU": 1, "GPU": 1})).fit()
    assert sorted(t.last_result["score"] for t in grid.trials) == [1, 2]
    assert (tmp_path / "experiment_state.json").is_file()


def test_chip_smoke_tune_phase_on_the_cpu():
    """chip_smoke.py's phase 13 at a small size on the CPU: PBT over the
    train step with the flash path's plain versions, the standalone and
    donor loss checks, and an lr that diverges at this size in place of
    3e-1 (the card's), so that both of its trials are exploited."""
    import sys
    from pathlib import Path

    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    config = dict(chip_smoke.TRAIN_CONFIG, vocab_size=512, dim=256,
                  n_layers=2, n_heads=2, n_kv_heads=1, ffn_dim=512)
    out = chip_smoke.phase_tune(torch.device("cpu"), config, (2, 64),
                                lrs=(1e-3, 1e-3, 10.0, 10.0))
    assert {e["trial"] for e in out["exploits"]} >= {"t0002", "t0003"}
    assert out["steps"] >= 4 * chip_smoke.TUNE_ITERATIONS \
        * chip_smoke.TUNE_STEPS_PER_REPORT // 2
    assert not any(out["launches"].values())
    assert not ray_tpu_torch.is_initialized()
