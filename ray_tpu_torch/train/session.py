"""Per-worker training session context.

Reference: python/ray/train/_internal/session.py (report/get_context) and
train/v2 session semantics: `report(metrics, checkpoint=...)` streams
metrics to the controller and persists checkpoints rank-0-only.

The PyTorch port of ``ray_tpu/train/session.py``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager

_local = threading.local()


class TrainContext:
    def __init__(self, rank: int, world_size: int, storage_path: str,
                 ckpt_manager: Optional[CheckpointManager] = None,
                 restore_from: Optional[Checkpoint] = None,
                 train_loop_config: Optional[dict] = None,
                 checkpoint_frequency: int = 0,
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 mesh_spec: Any = None):
        self.rank = rank
        self.world_size = world_size
        self.storage_path = storage_path
        self.ckpt_manager = ckpt_manager
        self.restore_from = restore_from
        self.train_loop_config = train_loop_config or {}
        self.checkpoint_frequency = checkpoint_frequency
        self.dataset_shards = dataset_shards or {}
        self.mesh_spec = mesh_spec
        self.reported: List[Dict[str, Any]] = []
        self.step = 0
        self._last_report_t: Optional[float] = None
        # step-hiccup telemetry: steady-state step time (EMA over steps
        # with no save in flight) vs the worst step seen during a save
        self._steady_step_ema: Optional[float] = None
        # cross-host straggler attribution: every rank publishes its
        # per-phase step times under this run-scoped KV prefix; rank 0
        # ("host 0") compares them into train_phase_skew_s gauges and
        # train_straggler journal events (trace-id-linked per run)
        import hashlib
        run_key = hashlib.md5(storage_path.encode()).hexdigest()[:8]
        self._phase_kv_prefix = f"train/phases/{run_key}"
        self._trace_id = f"train:{run_key}"
        self._last_phase_t: Optional[float] = None
        self._straggler_hosts: set = set()

    # -- API used inside train_loop_per_worker ------------------------------
    def get_world_size(self) -> int:
        return self.world_size

    def get_rank(self) -> int:
        return self.rank

    def report(self, metrics: Dict[str, Any],
               checkpoint_tree: Any = None) -> None:
        """Record metrics; optionally snapshot a pytree checkpoint.

        With CheckpointConfig.checkpoint_frequency=N, only every Nth report
        persists the offered tree (reference: air CheckpointConfig — the
        trainer thins framework-offered checkpoints, not user metrics).

        Saves are SHARDED: every rank persists only its addressable shards
        (no gather collective, no full tree on any host), so all ranks must
        offer the checkpoint_tree on the same steps. With
        CheckpointConfig.async_save the call only pays the device→host
        copy; otherwise rank 0 returns with the manifest committed.
        """
        from ray_tpu_torch.util.fault_injector import fire
        fire("train.report")
        # rank-addressable point: chaos tests slow ONE host of a gang
        # (RTPT_FAULT_INJECT="train.report.rank1=sleep:0.4") to prove the
        # straggler attribution path end-to-end
        fire(f"train.report.rank{self.rank}")
        self.step += 1
        entry = dict(metrics)
        entry["_step"] = self.step
        if self.checkpoint_frequency > 0 \
                and self.step % self.checkpoint_frequency != 0:
            checkpoint_tree = None
        if checkpoint_tree is not None and self.ckpt_manager is not None:
            if self.ckpt_manager.async_save:
                self.ckpt_manager.save_async(
                    checkpoint_tree, self.step,
                    metrics if self.rank == 0 else None)
            else:
                self.ckpt_manager.save(
                    checkpoint_tree, self.step,
                    metrics if self.rank == 0 else None)
            entry["_checkpoint_path"] = self.ckpt_manager.dir_for(self.step)
        self.reported.append(entry)
        if self.rank == 0:
            self._emit_step_gauges(metrics)
        self._publish_host_phases(metrics)

    def _emit_step_gauges(self, metrics: Dict[str, Any]) -> None:
        """Built-in L5 train telemetry (rank 0): step time and throughput
        from the wall clock between report() calls; MFU only when the loop
        reports `flops_per_step` and peak FLOPs is known (RTPT_PEAK_FLOPS
        env or a `peak_flops` metric). Rides the normal per-worker
        telemetry flush — best-effort, never fails the training loop."""
        now = time.monotonic()
        prev, self._last_report_t = self._last_report_t, now
        if prev is None:
            return
        dt = now - prev
        if dt <= 0:
            return
        try:
            from ray_tpu_torch.util import metrics as metrics_mod
            metrics_mod.train_step_time_gauge().set(dt)
            metrics_mod.train_throughput_gauge().set(1.0 / dt)
            # step hiccup: how much worse a step got while an async save
            # was in flight, vs the steady-state (no-save) EMA
            saving = self.ckpt_manager is not None \
                and self.ckpt_manager.in_flight()
            if saving and self._steady_step_ema:
                metrics_mod.train_checkpoint_step_hiccup_seconds_gauge() \
                    .set(max(0.0, dt - self._steady_step_ema))
            elif not saving:
                ema = self._steady_step_ema
                self._steady_step_ema = dt if ema is None \
                    else 0.8 * ema + 0.2 * dt
            flops = metrics.get("flops_per_step")
            peak = metrics.get("peak_flops") \
                or float(os.environ.get("RTPT_PEAK_FLOPS", 0) or 0)
            if flops and peak:
                metrics_mod.train_mfu_gauge().set(
                    float(flops) / (dt * float(peak)))
            phases = metrics.get("phases")
            if isinstance(phases, dict):
                # step-phase attribution (train.step_profiler breakdown,
                # or any loop timing its own phases)
                for phase, secs in phases.items():
                    metrics_mod.train_phase_time_gauge().set(
                        float(secs), tags={"phase": str(phase)})
        except Exception:  # noqa: BLE001
            pass

    # -- cross-host straggler attribution ------------------------------------

    def _publish_host_phases(self, metrics: Dict[str, Any]) -> None:
        """Every rank publishes its latest per-phase step times (user
        `phases` dict + the implicit wall-clock 'step' phase) to the head
        KV under a run-scoped key; rank 0 compares all hosts each report.
        Best-effort telemetry: never fails or slows the training loop
        beyond one small KV write (plus world_size reads on rank 0)."""
        try:
            from ray_tpu_torch.core.config import GlobalConfig
            factor = float(GlobalConfig.train_straggler_factor)
        except Exception:  # noqa: BLE001
            factor = 0.0
        if self.world_size <= 1 or factor <= 0:
            return
        now = time.monotonic()
        prev, self._last_phase_t = self._last_phase_t, now
        phases: Dict[str, float] = {}
        user = metrics.get("phases")
        if isinstance(user, dict):
            for k, v in user.items():
                try:
                    phases[str(k)] = float(v)
                except (TypeError, ValueError):
                    pass
        if prev is not None and now > prev:
            # the implicit whole-step phase: detection works even for
            # loops that never time their own phases
            phases["step"] = now - prev
        if not phases:
            return
        try:
            from ray_tpu_torch.core.worker import global_worker
            backend = getattr(global_worker, "backend", None)
            if backend is None:
                return
            backend.kv_put(
                f"{self._phase_kv_prefix}/{self.rank}",
                {"step": self.step, "ts": time.time(), "phases": phases})
            if self.rank == 0:
                self._compare_host_phases(backend, factor, phases)
        except Exception:  # noqa: BLE001 — telemetry must never fail a step
            pass

    def _compare_host_phases(self, backend, factor: float,
                             my_phases: Dict[str, float]) -> None:
        """Host 0's comparison pass: latest phase times of every host
        side by side -> train_phase_skew_s{phase,host} gauges; a host
        slower than the fastest by more than `factor` lands ONE
        train_straggler journal event per excursion (re-armed when the
        host catches back up), trace-id-linked to this run."""
        per_host: Dict[int, Dict[str, float]] = {0: my_phases}
        cutoff = time.time() - 60.0
        for rank in range(1, self.world_size):
            v = backend.kv_get(f"{self._phase_kv_prefix}/{rank}")
            # latest window per host, guarded by staleness (a dead or
            # not-yet-reporting host must not be compared): steps may
            # legitimately drift apart when hosts run uncoupled
            if isinstance(v, dict) and v.get("phases") \
                    and float(v.get("ts", 0)) >= cutoff:
                per_host[rank] = v["phases"]
        if len(per_host) < 2:
            return
        from ray_tpu_torch.util import metrics as metrics_mod
        gauge = metrics_mod.train_phase_skew_gauge()
        all_phases = set()
        for p in per_host.values():
            all_phases.update(p)
        stragglers: Dict[int, Dict[str, float]] = {}
        for phase in sorted(all_phases):
            times = {h: float(p[phase]) for h, p in per_host.items()
                     if phase in p}
            if len(times) < 2:
                continue
            fastest = min(times.values())
            for host, t in times.items():
                gauge.set(max(0.0, t - fastest),
                          tags={"phase": phase, "host": str(host)})
                if fastest > 1e-6 and t / fastest > factor:
                    stragglers.setdefault(host, {})[phase] = \
                        round(t / fastest, 2)
        for host, worst in stragglers.items():
            if host not in self._straggler_hosts:
                self._journal_straggler(host, worst)
        self._straggler_hosts = set(stragglers)

    def _journal_straggler(self, host: int,
                           worst: Dict[str, float]) -> None:
        from ray_tpu_torch.train.checkpoint import _journal
        _journal("train_straggler", trace_id=self._trace_id,
                 host=str(host), rank=host, step=self.step,
                 world_size=self.world_size,
                 slowdown_factors=worst)

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.restore_from

    def global_mesh(self):
        """The job-wide DeviceMesh: ScalingConfig.mesh over the ranks of
        the run's process group (train/backend.py)."""
        from ray_tpu_torch.train.backend import global_mesh
        return global_mesh(self.mesh_spec)

    def get_dataset_shard(self, name: str = "train"):
        """This worker's shard of JaxTrainer(datasets={name: ...}) as a
        DataIterator (reference: train session get_dataset_shard)."""
        if name not in self.dataset_shards:
            raise KeyError(
                f"no dataset {name!r} was passed to the trainer "
                f"(have: {sorted(self.dataset_shards)})")
        from ray_tpu_torch.data.iterator import DataIterator
        return DataIterator(self.dataset_shards[name])


def _set_context(ctx: Optional[TrainContext]) -> None:
    _local.ctx = ctx


def get_context() -> TrainContext:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError("not inside a ray_tpu_torch.train worker loop")
    return ctx


def report(metrics: Dict[str, Any], checkpoint_tree: Any = None) -> None:
    get_context().report(metrics, checkpoint_tree)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_context().get_checkpoint()


def get_dataset_shard(name: str = "train"):
    return get_context().get_dataset_shard(name)
