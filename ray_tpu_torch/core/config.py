"""Central config table, env-var overridable.

Mirrors the reference's single-macro-table design (reference:
src/ray/common/ray_config_def.h:18,22 — `RAY_CONFIG(type, name, default)`,
overridable via `RAY_<name>` env vars). Here every entry is declared once in
`_CONFIG_DEFS` and can be overridden with `RTPT_<name>` in the environment
(the JAX package reads `RTPU_<name>`: neither package sees the other's).
The same table is serialized and passed to every spawned daemon/worker so the
whole cluster sees one consistent config (reference: services.py system-config
propagation).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

_ENV_PREFIX = "RTPT_"

# name -> (type, default, help)
_CONFIG_DEFS: dict[str, tuple[type, Any, str]] = {
    # --- object store ---
    "object_store_memory_bytes": (int, 2 * 1024**3, "per-node shm arena size"),
    "object_store_max_objects": (int, 1 << 17, "object table slots in the arena"),
    "memory_store_threshold_bytes": (int, 100 * 1024, "objects <= this inline in the owner memory store; larger go to shm"),
    "object_transfer_chunk_bytes": (int, 5 * 1024**2, "chunk size for node-to-node object push"),
    "object_pull_retry_ms": (int, 200, "pull retry interval"),
    "object_pull_chunk_inflight": (int, 8, "pipelined chunk requests per pull (reference: PushManager max_chunks_in_flight)"),
    "object_pull_max_concurrent": (int, 4, "concurrent large-object pulls per process (reference: PullManager admission control)"),
    "object_accounting": (bool, True, "object-plane accounting: per-object directory + spill/pull counters riding telemetry_push ('python -m ray_tpu_torch memory'); disable to A/B the bookkeeping overhead (bench_core object_accounting row)"),
    # --- rpc ---
    "rpc_connect_timeout_s": (float, 10.0, "client connect timeout"),
    "rpc_call_timeout_s": (float, 60.0, "default unary call deadline"),
    "rpc_retry_max_attempts": (int, 5, "retryable client attempts"),
    "rpc_retry_base_ms": (int, 100, "exponential backoff base"),
    # chaos injection: "Service.Method=N" comma list — fail the first N calls
    # (reference: src/ray/rpc/rpc_chaos.h:23, RAY_testing_rpc_failure)
    "testing_rpc_failure": (str, "", "inject rpc failures: Method=N[,Method=N]"),
    "testing_rpc_delay_ms": (int, 0, "inject fixed delay into every rpc"),
    # --- scheduling ---
    "lease_idle_linger_s": (float, 0.5, "idle lease kept this long for reuse before release"),
    "max_pending_lease_requests": (int, 10, "lease requests in flight per resource shape (reference: max_pending_lease_requests_per_scheduling_category)"),
    "fast_lease_pool_target": (int, 4, "grants pre-stocked per resource shape in the head's native lease pool (0 disables the C fast path); kept shallow — instant grants bypass the RPC latency that naturally throttles worker fan-out"),
    "fast_lease_idle_drain_s": (float, 3.0, "pooled fast-lease grants idle longer than this drain back to the cluster (short: the pool refills in one RPC round-trip on the next burst, and held capacity must not mask node idleness from the autoscaler)"),
    "task_push_batch": (int, 32, "max tasks coalesced into one push frame per lease/actor"),
    "task_burst_defer": (bool, True, "defer bursty normal-task submits to the shared flusher (batch coalescing)"),
    "task_combined_push": (bool, True, "ship multi-task batches as ONE combined frame with one combined reply (vs per-task frames)"),
    "worker_pool_prestart": (int, 0, "workers prestarted per node"),
    "worker_pool_max": (int, 64, "max workers per node"),
    "worker_idle_timeout_s": (float, 300.0, "idle worker reap time"),
    "scheduler_spread_threshold": (float, 0.5, "hybrid policy: utilization above which we spread instead of pack"),
    "scheduler_top_k_fraction": (float, 0.2, "hybrid policy: random choice among best k nodes"),
    # --- health / fault tolerance ---
    "health_check_period_ms": (int, 1000, "GCS -> node ping period"),
    "health_check_timeout_ms": (int, 5000, "missed-deadline before node marked dead"),
    "node_head_watch_period_s": (float, 0.5, "node -> head liveness/incarnation poll period"),
    "head_recovery_grace_s": (float, 5.0, "restarted head waits this long for nodes to re-register before declaring unreconciled actors/PGs lost"),
    "task_max_retries_default": (int, 3, "default retries for normal tasks"),
    "memory_monitor_refresh_ms": (int, 250, "node RSS poll period; 0 disables the memory monitor (reference: memory_monitor_refresh_ms)"),
    "memory_usage_threshold": (float, 0.95, "node memory fraction above which the OOM killer picks a victim (reference: memory_usage_threshold)"),
    "worker_memory_limit_bytes": (int, 0, "per-worker RSS cap, 0 = none; over-limit workers are OOM-killed"),
    "worker_cgroup": (bool, True, "isolate workers in per-worker cgroup-v2 leaves (best-effort; no-op without a writable unified hierarchy)"),
    "cgroup_root": (str, "/sys/fs/cgroup", "cgroup-v2 mount point (injectable for tests)"),
    "infeasible_grace_s": (float, 30.0, "wait for autoscaling before failing infeasible resource shapes"),
    "actor_max_restarts_default": (int, 0, "default actor restarts"),
    "max_lineage_bytes": (int, 64 * 1024**2, "lineage cache cap per owner"),
    # --- train / ml ---
    "train_health_poll_s": (float, 2.0, "train controller worker poll"),
    "train_straggler_factor": (float, 2.0, "cross-host straggler attribution: rank 0 compares per-host train phase times each step, and a host slower than the fastest host by more than this factor raises train_phase_skew_s{phase,host} plus a train_straggler journal event naming the lagging host; 0 disables the comparison"),
    # --- llm serving ---
    "llm_prefix_cache": (bool, True, "share page-aligned prompt-prefix KV pages across requests (vLLM-style automatic prefix caching; LRU-evicted under allocator pressure)"),
    "llm_prefill_chunk": (int, 512, "prompts (or uncached tails) longer than this prefill in chunks interleaved with decode steps, so one long prompt never stalls the running batch for a full prefill dispatch"),
    "llm_step_token_budget": (int, 2048, "max prefill tokens scheduled per engine step (decode-priority continuous batching); 0 = unbounded"),
    "llm_admit_lookahead": (int, 16, "waiting requests scanned past a non-admittable head for same-bucket/admissible prompts (head-of-line fix)"),
    "llm_admit_age_cap_s": (float, 5.0, "a head request older than this stops lookahead skipping so freed pages go to it first (no starvation)"),
    "llm_kv_dtype": (str, "model", "KV page storage scheme: 'model' (engine dtype) or 'int8' (quantized pages + bf16 per-token scales; ~1.9x concurrent sequences per HBM byte at head_dim 64)"),
    "llm_ragged_prefill_rows": (int, 2, "prefill-chunk rows packed into each ragged step dispatch (ragged token capacity = max_batch + rows*prefill_chunk); more rows advance more prompts per step at the cost of padding when the queue is shallow"),
    "llm_request_log": (bool, True, "per-request flight recorder (lifecycle events, TTFT/TPOT histograms, 'python -m ray_tpu_torch requests'); disable to shave the last % off the step loop"),
    "llm_request_log_size": (int, 256, "request records kept in the engine-side ring (and in the head-side aggregate ring); oldest finished records evict first"),
    "llm_slo_ttft_ms": (float, 200.0, "time-to-first-token SLO target; llm_slo_ttft_attainment reports the fraction of finished requests under it"),
    "llm_slo_tpot_ms": (float, 20.0, "time-per-output-token SLO target (mean inter-token latency after the first); llm_slo_tpot_attainment reports attainment"),
    # --- serving control loop (serve/controller.py 'slo' policy) ---
    "serve_slo_window_s": (float, 10.0, "sliding window of finished requests the SLO autoscaling policy evaluates attainment over (too short: scale thrash on noise; too long: slow reflexes)"),
    "serve_slo_target_attainment": (float, 0.95, "fraction of windowed requests that must meet BOTH llm_slo_ttft_ms and llm_slo_tpot_ms; below target scales replicas up, sustained above (with headroom) drains down"),
    "serve_slo_eval_period_s": (float, 1.0, "SLO policy evaluation period (controller reconcile passes between policy decisions are a no-op)"),
    "serve_slo_scale_down_evals": (int, 10, "consecutive over-target evaluations (with attainment headroom at n-1 replicas) before a drain-and-pack scale-down; hysteresis against diurnal noise"),
    "serve_overload_steps": (int, 3, "consecutive below-target evaluations AT max replicas before the degradation ladder escalates one level (admission tightening, then shedding)"),
    "serve_overload_budget_factor": (float, 0.5, "per-level multiplier applied to llm_step_token_budget while overloaded: level n runs at budget*factor**n (tighter admission keeps decode TPOT alive at the cost of prefill throughput)"),
    "serve_overload_max_level": (int, 3, "degradation ladder ceiling; at max level with a configured shed model, excess requests re-route to the cheaper model via multiplex routing (overload_shed_total counts them)"),
    # --- instance lifecycle (runtime/instance_manager.py) ---
    "instance_orphan_grace_s": (float, 15.0, "restart reconcile terminates a REQUESTED/ALLOCATED instance whose node never registered only after this age — younger launches may still be booting and get adopted instead (raise well above slice boot time for cloud providers)"),
    # --- misc ---
    "session_dir": (str, os.path.join(tempfile.gettempdir(), "ray_tpu_torch"), "root for session artifacts (under $TMPDIR)"),
    "log_to_driver": (bool, True, "forward worker logs to driver"),
    "event_buffer_size": (int, 10000, "task event buffer cap"),
    "metrics_export_period_s": (float, 5.0, "metrics push period"),
    "hw_sampler_period_s": (float, 2.0, "node hardware sampler period (cpu/rss/cgroup/arena/gpu); 0 disables"),
    "profile_enabled": (bool, False, "continuous wall-clock stack sampler (util/stack_profiler.py) in every process — head, node daemons, workers, drivers; collapsed-stack profiles ride telemetry_push into the head's ProfileStore. Off by default: nothing in this package reads the profiles yet, and the sampler's cost on a serving worker is not measured"),
    "profile_hz": (float, 19.0, "continuous profiler sampling rate (Hz); the prime-ish default never phase-locks with the 1-2s periodic loops it observes, so those loops sample in proportion to the time they actually burn; burst captures ('profile --record S --hz N') pick their own rate"),
    "profile_table_size": (int, 512, "distinct collapsed stacks held per process between telemetry flushes; samples landing on new stacks once the table is full are dropped and counted exactly (the profile keeps an honest denominator: profile_dropped_samples_total)"),
    "log_plane_enabled": (bool, True, "structured log plane (util/log_plane.py) in every process — head, node daemons, workers, drivers; JSON-lines records dual-sunk into the per-node session log directory (rotated files) and a bounded ring riding telemetry_push into the head's LogStore ('python -m ray_tpu_torch logs'); disable to A/B the logging overhead"),
    "log_ring_records": (int, 1024, "log records buffered per process between telemetry flushes; overflow drops the OLDEST and counts it exactly (log_dropped_records_total — the export invariant 'emitted == stored + dropped' always holds)"),
    "log_file_max_bytes": (int, 8 * 1024**2, "size cap per structured log file (head.log / node-<id>.log / worker-<id>.log) before rotation to .1..N; the raw worker .out/.err streams are capped only by worker lifetime"),
    "log_file_backups": (int, 1, "rotated generations kept per structured log file (file.1 .. file.N; oldest deleted on rotation)"),
    "log_death_tail_lines": (int, 20, "stderr + structured-log tail lines the node daemon attaches to a worker_death journal record (crash forensics: 'events --frames' shows the dying words next to the exit cause); 0 disables the capture"),
    "log_error_storm_threshold": (int, 50, "error records within log_error_storm_window_s that raise ONE log_error_storm cluster-journal event per excursion (re-armed when the rate halves); 0 disables storm detection"),
    "log_error_storm_window_s": (float, 10.0, "sliding window for error-storm rate detection"),
    "compile_tracker_enabled": (bool, True, "XLA compile/dispatch tracker (util/compile_tracker.py) in every jax-bearing process: jax.monitoring listeners plus the jit cache-miss wrap seam record each compile (callable, module fingerprint, arg shape/dtype signature, duration, backend, trace id) into a bounded ring riding telemetry_push into the head's CompileStore ('python -m ray_tpu_torch compiles'); disable to A/B the tracking overhead (BENCH_profile.json records it at <2%)"),
    "compile_ring_records": (int, 512, "compile records buffered per process between telemetry flushes; overflow drops the OLDEST and counts it exactly, so the export ledger 'emitted == exported + stored + dropped' always holds and the head's dropped_total is an honest under-report bound"),
    "compile_storm_threshold": (int, 8, "recompiles (same callable, NEW arg signature) within compile_storm_window_s that raise ONE compile_storm cluster-journal event per excursion (re-armed when the rate falls below half); the dominant TPU unexplained-latency failure is a silent recompile storm from unstable shapes — this makes it a cluster event with the offending callable and signature diff attached; 0 disables detection"),
    "compile_storm_window_s": (float, 60.0, "sliding window for recompile-storm rate detection; size it to a few training steps / serving windows so one legitimate warmup sweep (N distinct shapes compiled once) ages out instead of re-firing"),
    "timeseries_ring_points": (int, 512, "points kept per (node, metric) hardware time series at the head"),
    "cluster_event_journal_size": (int, 4096, "structured cluster events (node/worker/actor/spill/lease/autoscaler transitions) kept in the head's journal ring ('python -m ray_tpu_torch events'); oldest evict first"),
}


class _Config:
    """Attribute access over the config table with env overrides applied once."""

    def __init__(self, overrides: dict[str, Any] | None = None):
        self._values: dict[str, Any] = {}
        for name, (typ, default, _help) in _CONFIG_DEFS.items():
            value = default
            env = os.environ.get(_ENV_PREFIX + name)
            if env is not None:
                value = _parse(typ, env)
            self._values[name] = value
        if overrides:
            self.apply(overrides)

    def apply(self, overrides: dict[str, Any]) -> None:
        for name, value in overrides.items():
            if name not in _CONFIG_DEFS:
                raise ValueError(f"unknown config {name!r}")
            typ = _CONFIG_DEFS[name][0]
            self._values[name] = _parse(typ, value) if isinstance(value, str) else typ(value)

    def __getattr__(self, name: str):
        try:
            return self.__dict__["_values"][name]
        except KeyError:
            raise AttributeError(name) from None

    def apply_env_overrides(self) -> None:
        """Re-read RTPT_* from this process's environment ON TOP of any
        applied table — lets a spawned worker's runtime_env env_vars
        override the cluster-propagated config for that worker only."""
        for name, (typ, _default, _help) in _CONFIG_DEFS.items():
            env = os.environ.get(_ENV_PREFIX + name)
            if env is not None:
                self._values[name] = _parse(typ, env)

    def to_json(self) -> str:
        return json.dumps(self._values)

    @classmethod
    def from_json(cls, payload: str) -> "_Config":
        cfg = cls()
        cfg.apply(json.loads(payload))
        return cfg


def _parse(typ: type, raw: Any) -> Any:
    if typ is bool:
        if isinstance(raw, bool):
            return raw
        return str(raw).lower() in ("1", "true", "yes", "on")
    return typ(raw)


GlobalConfig = _Config()


def reset_to_defaults() -> None:
    """Restore the table to defaults + env overrides, IN PLACE so every
    `from ... import GlobalConfig` alias sees it. init() calls this
    before applying a session's _system_config: without it, overrides
    from a previous init() in the same process (e.g. an earlier test's
    worker_pool_max) silently leak into the next session's cluster."""
    fresh = _Config()
    GlobalConfig._values.clear()
    GlobalConfig._values.update(fresh._values)


def reload_from_env() -> None:
    """Re-read env overrides (used by spawned workers after env setup)."""
    global GlobalConfig
    GlobalConfig = _Config()
