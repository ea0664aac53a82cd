"""Trial schedulers: FIFO, ASHA, PBT.

The port of ``ray_tpu/tune/schedulers.py``, copied. Role-equivalent to
the reference's TrialScheduler family (reference:
tune/schedulers/trial_scheduler.py, async_hyperband.py ASHAScheduler,
pbt.py:221 PopulationBasedTraining). Decisions are made per-result, between
trial iterations — the controller delivers one result at a time per trial.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.search import resample_key
from ray_tpu_torch.tune.trial import Trial


class Decision:
    CONTINUE = "CONTINUE"
    STOP = "STOP"


class TrialScheduler:
    def set_experiment(self, metric: str, mode: str,
                       param_space: Dict[str, Any]) -> None:
        self.metric = metric
        self.sign = 1.0 if mode == "max" else -1.0
        self.param_space = param_space

    def on_result(self, trial: Trial, result: Dict[str, Any],
                  all_trials: List[Trial]) -> str:
        return Decision.CONTINUE

    def on_trial_complete(self, trial_id: str) -> None:
        """Trial terminated/errored: schedulers drop per-trial state so
        long sweeps don't accumulate it unboundedly."""

    def score(self, trial_or_result) -> Optional[float]:
        src = trial_or_result.last_result \
            if isinstance(trial_or_result, Trial) else trial_or_result
        v = src.get(self.metric)
        return None if v is None else self.sign * float(v)


class FIFOScheduler(TrialScheduler):
    pass


class ASHAScheduler(TrialScheduler):
    """Asynchronous successive halving (reference: async_hyperband.py).

    Rung milestones are grace_period * reduction_factor**k. When a trial
    reaches a milestone its score joins the rung; trials below the top
    1/reduction_factor quantile of their rung stop immediately — no
    synchronized brackets, so fast trials never wait on slow ones.
    """

    def __init__(self, *, time_attr: str = "training_iteration",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4):
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.milestones: List[int] = []
        t = grace_period
        while t < max_t:
            self.milestones.append(t)
            t *= reduction_factor
        self._rungs: Dict[int, List[float]] = defaultdict(list)
        self._passed: Dict[str, set] = defaultdict(set)

    def on_result(self, trial: Trial, result: Dict[str, Any],
                  all_trials: List[Trial]) -> str:
        t = int(result.get(self.time_attr, 0))
        if t >= self.max_t:
            return Decision.STOP
        s = self.score(result)
        if s is None:
            return Decision.CONTINUE
        decision = Decision.CONTINUE
        for m in self.milestones:
            if t >= m and m not in self._passed[trial.trial_id]:
                self._passed[trial.trial_id].add(m)
                rung = self._rungs[m]
                rung.append(s)
                cutoff = self._cutoff(rung)
                if cutoff is not None and s < cutoff:
                    decision = Decision.STOP
        return decision

    def _cutoff(self, rung: List[float]) -> Optional[float]:
        if len(rung) < self.rf:
            return None  # not enough evidence at this rung yet
        ordered = sorted(rung, reverse=True)
        k = max(1, len(ordered) // self.rf)
        return ordered[k - 1]

    def on_trial_complete(self, trial_id: str) -> None:
        # rung scores stay (they gate later trials); the per-trial
        # milestone set is only consulted while the trial reports
        self._passed.pop(trial_id, None)


class PopulationBasedTraining(TrialScheduler):
    """PBT with truncation selection (reference: tune/schedulers/pbt.py:221).

    Every ``perturbation_interval`` iterations a trial becomes ready; if it
    sits in the bottom quantile it EXPLOITS a random top-quantile trial
    (clone its checkpoint + config) and EXPLORES the cloned config
    (perturb numeric keys ×1.2 / ×0.8 or resample with prob
    ``resample_probability``). The controller performs the actual actor
    restart when we return an exploit directive via trial._pbt_exploit.
    """

    def __init__(self, *, time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self.rng = random.Random(seed)
        self._last_perturb: Dict[str, int] = defaultdict(int)

    def on_trial_complete(self, trial_id: str) -> None:
        self._last_perturb.pop(trial_id, None)

    def on_result(self, trial: Trial, result: Dict[str, Any],
                  all_trials: List[Trial]) -> str:
        t = int(result.get(self.time_attr, 0))
        if t - self._last_perturb[trial.trial_id] < self.interval:
            return Decision.CONTINUE
        self._last_perturb[trial.trial_id] = t
        scored = [(self.score(x), x) for x in all_trials
                  if self.score(x) is not None]
        if len(scored) < 2:
            return Decision.CONTINUE
        scored.sort(key=lambda p: p[0])
        n = len(scored)
        k = max(1, int(n * self.quantile))
        bottom = [x for _, x in scored[:k]]
        top = [x for _, x in scored[-k:]]
        if trial in bottom and trial not in top:
            # Exploit clones the source's STATE; a source that never
            # checkpointed has none to give — cloning would just reset the
            # target to iteration 0 every interval.
            eligible = [t for t in top if t.checkpoint_path is not None]
            if not eligible:
                return Decision.CONTINUE
            source = self.rng.choice(eligible)
            new_config = self._explore(dict(source.config))
            # directive consumed by the controller (restart w/ clone state)
            trial._pbt_exploit = {  # noqa: SLF001
                "source_id": source.trial_id,
                "checkpoint_path": source.checkpoint_path,
                "config": new_config,
            }
        return Decision.CONTINUE

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        for key, space in self.mutations.items():
            if self.rng.random() < self.resample_p:
                fresh = resample_key({key: space}, key, self.rng)
                if fresh is not None:
                    config[key] = fresh
                    continue
            cur = config.get(key)
            if isinstance(cur, (int, float)) and not isinstance(cur, bool):
                factor = 1.2 if self.rng.random() < 0.5 else 0.8
                config[key] = type(cur)(cur * factor) \
                    if isinstance(cur, float) else max(1, int(cur * factor))
            else:
                fresh = resample_key({key: space}, key, self.rng)
                if fresh is not None:
                    config[key] = fresh
        return config


class MedianStoppingRule(TrialScheduler):
    """Median stopping (reference: tune/schedulers/median_stopping_rule.py,
    the Vizier rule): a trial stops at step t when its RUNNING-AVERAGE
    result is worse than the median of the other trials' running averages
    at the same step — a distribution-free early-stopping rule that
    complements ASHA (quantile-per-rung) with a per-step median gate.

    ``grace_period`` steps always run; the rule activates once
    ``min_samples_required`` other trials have reported at step t.
    """

    def __init__(self, *, time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        # trial_id -> (sum, count) of scores; and per-step running-average
        # snapshots: step -> {trial_id: running_avg}
        self._sums: Dict[str, List[float]] = {}
        self._at_step: Dict[int, Dict[str, float]] = defaultdict(dict)
        self._seen_steps: Dict[str, set] = defaultdict(set)

    def on_trial_complete(self, trial_id: str) -> None:
        # a finished trial's running average can't change: drop its
        # accumulator + dedupe set. The per-step snapshots STAY — they
        # are the median pool that gates later-arriving trials (removing
        # them would let every straggler run ungated once the strong
        # early trials finish).
        self._sums.pop(trial_id, None)
        self._seen_steps.pop(trial_id, None)

    def on_result(self, trial: Trial, result: Dict[str, Any],
                  all_trials: List[Trial]) -> str:
        s = self.score(result)
        if s is None:
            return Decision.CONTINUE
        t = int(result.get(self.time_attr, 0))
        if t in self._seen_steps[trial.trial_id]:
            # restore/replay re-reports a step already counted — feeding
            # it into the running average would double-weight that step
            # and skew the median gate
            return Decision.CONTINUE
        self._seen_steps[trial.trial_id].add(t)
        acc = self._sums.setdefault(trial.trial_id, [0.0, 0])
        acc[0] += s
        acc[1] += 1
        running = acc[0] / acc[1]
        self._at_step[t][trial.trial_id] = running
        if t <= self.grace_period:
            return Decision.CONTINUE
        others = [v for tid, v in self._at_step[t].items()
                  if tid != trial.trial_id]
        if len(others) < self.min_samples:
            return Decision.CONTINUE
        ordered = sorted(others)
        mid = len(ordered) // 2
        # true median: even counts average the middle pair (taking the
        # upper-middle would stop trials that beat the real median)
        median = ordered[mid] if len(ordered) % 2 \
            else (ordered[mid - 1] + ordered[mid]) / 2.0
        if running < median:
            return Decision.STOP
        return Decision.CONTINUE
