"""Tuner / TuneConfig / ResultGrid — the user-facing surface.

The port of ``ray_tpu/tune/tuner.py``, copied. Role-equivalent to the
reference's Tuner (reference: tune/tuner.py:312
Tuner.fit) and ResultGrid (tune/result_grid.py). ``Tuner.restore``
re-hydrates a crashed experiment from the experiment_state.json the
controller checkpoints after every event.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.search import generate_variants
from ray_tpu_torch.tune.trial import Trial, TrialStatus
from ray_tpu_torch.tune.tune_controller import TuneController


@dataclass
class TuneConfig:
    metric: str = "loss"
    mode: str = "min"
    num_samples: int = 1
    scheduler: Optional[TrialScheduler] = None
    max_concurrent_trials: int = 0
    seed: Optional[int] = None
    # Searcher plugin (reference: tune/search/searcher.py seam). When set,
    # trials run in waves sized by max_concurrent_trials and results feed
    # back through on_trial_complete between waves, so sequential
    # model-based searchers actually see earlier results.
    search_alg: Optional[Any] = None


@dataclass
class TuneRunConfig:
    storage_path: Optional[str] = None
    name: Optional[str] = None
    max_failures_per_trial: int = 0
    resources_per_trial: Dict[str, float] = field(
        default_factory=lambda: {"CPU": 1.0})


class ResultGrid:
    def __init__(self, trials: List[Trial], metric: str, mode: str,
                 storage_path: str):
        self.trials = trials
        self.metric = metric
        self.mode = mode
        self.storage_path = storage_path

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Trial:
        metric = metric or self.metric
        sign = 1.0 if (mode or self.mode) == "max" else -1.0
        scored = [t for t in self.trials
                  if t.metric_value(metric) is not None]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        return max(scored, key=lambda t: sign * t.metric_value(metric))

    def get_dataframe(self) -> List[Dict[str, Any]]:
        """Rows of (trial_id, status, config.*, last_result.*) — plain
        dicts, not pandas (numpy-first policy)."""
        rows = []
        for t in self.trials:
            row = {"trial_id": t.trial_id, "status": t.status,
                   "iterations": t.iteration}
            row.update({f"config/{k}": v for k, v in t.config.items()})
            row.update(t.last_result)
            rows.append(row)
        return rows

    @property
    def errors(self) -> List[Trial]:
        return [t for t in self.trials if t.status == TrialStatus.ERRORED]


class Tuner:
    def __init__(self, trainable: Callable[[Dict[str, Any]], Any], *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[TuneRunConfig] = None):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or TuneRunConfig()
        self._restored_variants: Optional[List[Dict[str, Any]]] = None
        self._restored_state: Optional[Dict[str, Any]] = None

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        if tc.search_alg is not None and self._restored_variants is None:
            return self._fit_with_searcher()
        variants = self._restored_variants or generate_variants(
            self.param_space, tc.num_samples, seed=tc.seed)
        storage = self.run_config.storage_path
        if storage and self.run_config.name:
            storage = os.path.join(storage, self.run_config.name)
        controller = TuneController(
            self.trainable,
            param_space=self.param_space,
            variants=variants,
            metric=tc.metric, mode=tc.mode,
            scheduler=tc.scheduler,
            max_concurrent=tc.max_concurrent_trials,
            resources_per_trial=self.run_config.resources_per_trial,
            storage_path=storage,
            max_failures_per_trial=self.run_config.max_failures_per_trial,
            restore_state=(self._restored_state or {}).get("trials"))
        trials = controller.run()
        return ResultGrid(trials, tc.metric, tc.mode, controller.storage)

    def _fit_with_searcher(self) -> ResultGrid:
        """Wave-based execution for Searcher plugins. Note: searcher
        experiments persist per-wave state under wave_N/ and do NOT
        support Tuner.restore() of the whole run (the searcher's model
        state is not checkpointed — reference parity gap shared with
        stateful search plugins)."""
        tc = self.tune_config
        searcher = tc.search_alg
        searcher.set_search_properties(tc.metric, tc.mode, self.param_space)
        wave_size = tc.max_concurrent_trials or 4
        storage = self.run_config.storage_path
        if storage and self.run_config.name:
            storage = os.path.join(storage, self.run_config.name)
        all_trials: List[Trial] = []
        final_storage = storage
        wave = 0
        next_id = 0
        while True:
            batch = []  # [(searcher_id, config)]
            while len(batch) < wave_size:
                sid = f"srch_{next_id}"
                cfg = searcher.suggest(sid)
                if cfg is None:
                    break
                batch.append((sid, cfg))
                next_id += 1
            if not batch:
                break
            controller = TuneController(
                self.trainable,
                param_space=self.param_space,
                variants=[cfg for _, cfg in batch],
                metric=tc.metric, mode=tc.mode,
                scheduler=tc.scheduler,
                max_concurrent=tc.max_concurrent_trials,
                resources_per_trial=self.run_config.resources_per_trial,
                storage_path=(os.path.join(storage, f"wave_{wave}")
                              if storage else None),
                max_failures_per_trial=self.run_config
                .max_failures_per_trial)
            trials = controller.run()
            final_storage = controller.storage
            # feed results back in suggestion order (the controller keeps
            # variant order) so the searcher's model sees this wave before
            # proposing the next
            for (sid, _), t in zip(batch, trials):
                searcher.on_trial_complete(
                    sid, t.last_result if t.last_result else None)
                # disambiguate across waves: each controller restarts its
                # id counter at t0000
                t.trial_id = f"w{wave}_{t.trial_id}"
            all_trials.extend(trials)
            wave += 1
        return ResultGrid(all_trials, tc.metric, tc.mode, final_storage)

    @classmethod
    def restore(cls, storage_path: str,
                trainable: Callable[[Dict[str, Any]], Any], *,
                tune_config: Optional[TuneConfig] = None,
                run_config: Optional[TuneRunConfig] = None) -> "Tuner":
        """Resume an experiment: finished trials keep their results,
        unfinished ones re-run from their latest in-trial checkpoint."""
        # Prefer the pickle sidecar: JSON mangles non-JSON config values
        # (numpy scalars become repr strings, tuples become lists), which
        # must not be fed back into trainables as live hyperparameters.
        pkl = os.path.join(storage_path, "experiment_state.pkl")
        if os.path.exists(pkl):
            import cloudpickle
            with open(pkl, "rb") as f:
                state = cloudpickle.load(f)
        else:
            state_file = os.path.join(storage_path, "experiment_state.json")
            with open(state_file) as f:
                state = json.load(f)
        if tune_config is None:
            tune_config = TuneConfig(metric=state["metric"],
                                     mode=state["mode"])
        run_config = run_config or TuneRunConfig()
        run_config.storage_path = storage_path
        run_config.name = None
        tuner = cls(trainable, tune_config=tune_config,
                    run_config=run_config)
        tuner._restored_variants = [t["config"] for t in state["trials"]]
        tuner._restored_state = state
        return tuner
