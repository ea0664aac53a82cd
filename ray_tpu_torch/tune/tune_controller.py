"""TuneController — the experiment event loop.

The port of ``ray_tpu/tune/tune_controller.py``. Role-equivalent to the
reference's TuneController (reference:
tune/execution/tune_controller.py:68): owns trial lifecycle (launch as
actors with reserved resources, pull results, apply scheduler decisions,
PBT exploit restarts, failure retries) and experiment-state checkpointing
so an interrupted experiment resumes (reference: tune/execution/
experiment_state.py).
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.tune.schedulers import Decision, FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.trial import DONE, Trial, TrialRunner, TrialStatus

logger = logging.getLogger(__name__)


class TuneController:
    def __init__(self, trainable: Callable, *, param_space: Dict[str, Any],
                 variants: List[Dict[str, Any]], metric: str, mode: str,
                 scheduler: Optional[TrialScheduler] = None,
                 max_concurrent: int = 0,
                 resources_per_trial: Optional[Dict[str, float]] = None,
                 storage_path: Optional[str] = None,
                 max_failures_per_trial: int = 0,
                 restore_state: Optional[List[Dict[str, Any]]] = None):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.trainable = trainable
        self.metric = metric
        self.mode = mode
        self.scheduler = scheduler or FIFOScheduler()
        self.scheduler.set_experiment(metric, mode, param_space)
        self.resources = resources_per_trial or {"CPU": 1.0}
        self.storage = storage_path or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch_tune",
            f"exp_{uuid.uuid4().hex[:8]}")
        os.makedirs(self.storage, exist_ok=True)
        self.max_concurrent = max_concurrent
        self.max_failures = max_failures_per_trial
        self.trials = [
            Trial(trial_id=f"t{i:04d}", config=cfg)
            for i, cfg in enumerate(variants)]
        if restore_state:
            # Resume semantics: TERMINATED trials keep their results;
            # anything else restarts from its latest in-trial checkpoint
            # (reference: experiment_state.py resume path).
            by_id = {s["trial_id"]: s for s in restore_state}
            for t in self.trials:
                s = by_id.get(t.trial_id)
                if s is None:
                    continue
                t.checkpoint_path = s.get("checkpoint_path")
                t.last_result = s.get("last_result") or {}
                t.iteration = s.get("iteration", 0)
                if s.get("status") == TrialStatus.TERMINATED:
                    t.status = TrialStatus.TERMINATED
                    if t.last_result:
                        t.results.append(t.last_result)
        self._failures: Dict[str, int] = {}

    # ------------------------------------------------------------ lifecycle
    def _trial_dir(self, trial: Trial) -> str:
        return os.path.join(self.storage, trial.trial_id)

    def _launch(self, trial: Trial,
                restore_path: Optional[str] = None) -> None:
        cls = ray_tpu_torch.remote(**{
            "num_cpus": self.resources.get("CPU", 1.0),
            "resources": {k: v for k, v in self.resources.items()
                          if k != "CPU"} or None,
        })(TrialRunner)
        trial.actor = cls.remote(self.trainable, trial.config,
                                 self._trial_dir(trial),
                                 restore_path or trial.checkpoint_path)
        trial.status = TrialStatus.RUNNING
        trial.pending_ref = trial.actor.next_result.remote()

    def _stop_actor(self, trial: Trial) -> None:
        if trial.actor is not None:
            try:
                # Cooperative stop first: the stop() call enqueues behind the
                # outstanding next_result and unwinds the fn thread (sets the
                # stop event, drains the result queue so a blocked report()
                # returns, then StopTrial is raised at the next report).
                # kill() alone would leave the fn thread parked forever on a
                # full queue in local mode. The local actor queue is FIFO, so
                # stop is processed before the kill tombstone.
                trial.actor.stop.remote()
                ray_tpu_torch.kill(trial.actor)
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        trial.actor = None
        trial.pending_ref = None

    def _capacity(self) -> int:
        if self.max_concurrent > 0:
            return self.max_concurrent
        try:
            avail = ray_tpu_torch.cluster_resources().get("CPU", 1.0)
            need = max(self.resources.get("CPU", 1.0), 1e-9)
            return max(1, int(avail / need))
        except Exception:  # noqa: BLE001 — local mode w/o resource table
            return 4

    @staticmethod
    def _note_running_gauge(n: int) -> None:
        """Built-in L5 metric: trials currently holding an actor in this
        tuner process (best-effort — tuning never depends on telemetry)."""
        try:
            from ray_tpu_torch.util import metrics as metrics_mod
            metrics_mod.tune_running_trials_gauge().set(n)
        except Exception:  # noqa: BLE001
            pass

    # ------------------------------------------------------------ main loop
    def run(self) -> List[Trial]:
        pending = [t for t in self.trials if t.status == TrialStatus.PENDING]
        running: List[Trial] = []
        cap = self._capacity()
        while pending or running:
            while pending and len(running) < cap:
                t = pending.pop(0)
                self._launch(t)
                running.append(t)
            self._note_running_gauge(len(running))
            ref_to_trial = {t.pending_ref: t for t in running}
            done, _ = ray_tpu_torch.wait(list(ref_to_trial), num_returns=1,
                                   timeout=60)
            if not done:
                continue
            trial = ref_to_trial[done[0]]
            # Round-robin fairness: wait() scans refs in order, so without
            # rotation one always-ready trial would monopolize the loop and
            # the population would advance wildly unevenly — which breaks
            # PBT (exploit would clone checkpoints from trials many steps
            # ahead). Rotating keeps trials within ~1 iteration of lockstep.
            running.remove(trial)
            running.append(trial)
            try:
                result = ray_tpu_torch.get(done[0])
            except Exception as e:  # noqa: BLE001 — trial fault boundary
                self._on_trial_error(trial, e, pending, running)
                self._save_experiment_state()
                continue
            if result.get(DONE):
                trial.status = TrialStatus.TERMINATED
                self._stop_actor(trial)
                running.remove(trial)
                self.scheduler.on_trial_complete(trial.trial_id)
                self._save_experiment_state()
                continue
            self._on_trial_result(trial, result, pending, running)
        self._note_running_gauge(0)
        self._save_experiment_state()
        return self.trials

    def _on_trial_result(self, trial: Trial, result: Dict[str, Any],
                         pending: List[Trial], running: List[Trial]) -> None:
        trial.iteration = int(result.get("training_iteration",
                                         trial.iteration + 1))
        if "__checkpoint__" in result:
            trial.checkpoint_path = result.pop("__checkpoint__")
        trial.last_result = result
        trial.results.append(result)
        decision = self.scheduler.on_result(trial, result, self.trials)
        exploit = getattr(trial, "_pbt_exploit", None)
        if exploit is not None:
            del trial._pbt_exploit
            self._exploit(trial, exploit)
            return
        if decision == Decision.STOP:
            trial.status = TrialStatus.TERMINATED
            self._stop_actor(trial)
            running.remove(trial)
            self.scheduler.on_trial_complete(trial.trial_id)
        else:
            trial.pending_ref = trial.actor.next_result.remote()
        self._save_experiment_state()

    def _exploit(self, trial: Trial, directive: Dict[str, Any]) -> None:
        """PBT exploit: restart this trial from the source's checkpoint with
        the explored config (reference pbt.py _exploit)."""
        logger.info("tune/pbt: %s exploits %s", trial.trial_id,
                    directive["source_id"])
        self._stop_actor(trial)
        trial.config = directive["config"]
        trial.checkpoint_path = directive["checkpoint_path"]
        self._launch(trial, restore_path=directive["checkpoint_path"])

    def _on_trial_error(self, trial: Trial, error: Exception,
                        pending: List[Trial], running: List[Trial]) -> None:
        n = self._failures.get(trial.trial_id, 0) + 1
        self._failures[trial.trial_id] = n
        self._stop_actor(trial)
        if n <= self.max_failures:
            logger.warning("tune: trial %s failed (%d/%d), restarting: %r",
                           trial.trial_id, n, self.max_failures, error)
            self._launch(trial, restore_path=trial.checkpoint_path)
        else:
            trial.status = TrialStatus.ERRORED
            trial.error = repr(error)
            running.remove(trial)
            self.scheduler.on_trial_complete(trial.trial_id)

    # --------------------------------------------------------- persistence
    def _save_experiment_state(self) -> None:
        state = {
            "metric": self.metric, "mode": self.mode,
            "trials": [{
                "trial_id": t.trial_id,
                "config": _jsonable(t.config),
                "status": t.status,
                "iteration": t.iteration,
                "last_result": _jsonable(t.last_result),
                "checkpoint_path": t.checkpoint_path,
                "error": t.error,
            } for t in self.trials],
            "saved_at": time.time(),
        }
        tmp = os.path.join(self.storage, ".experiment_state.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, os.path.join(self.storage, "experiment_state.json"))
        # Pickle sidecar holds configs losslessly for Tuner.restore (the
        # JSON file is the human-readable view; see tuner.py restore).
        import cloudpickle
        state_pkl = dict(state)
        state_pkl["trials"] = [dict(s) for s in state["trials"]]
        for s, t in zip(state_pkl["trials"], self.trials):
            s["config"] = dict(t.config)
            s["last_result"] = dict(t.last_result)
        tmp = os.path.join(self.storage, ".experiment_state.pkl.tmp")
        with open(tmp, "wb") as f:
            cloudpickle.dump(state_pkl, f)
        os.replace(tmp, os.path.join(self.storage, "experiment_state.pkl"))


def _jsonable(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except (TypeError, ValueError):
            out[k] = repr(v)
    return out
