"""Application metrics: Counter / Gauge / Histogram — the port's own copy
of ``ray_tpu/util/metrics.py``.

Role-equivalent to the reference's metrics API (reference:
python/ray/util/metrics.py over the C++ OpenCensus registry,
src/ray/stats/metric.h:103): metrics register in a per-process registry;
``snapshot()`` reads it in wire form. In cluster mode the backend's
telemetry thread ships snapshots to the head, which aggregates across
workers (``aggregate``: sum for counters/histograms, last-write for
gauges) — queryable through the head's ``metrics`` RPC.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_DEFAULT_BOUNDS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60)


class _Registry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, "Metric"] = {}

    def register(self, metric: "Metric") -> None:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric):
                    raise ValueError(
                        f"metric {metric.name!r} already registered as "
                        f"{type(existing).__name__}")
                if metric.tag_keys != existing.tag_keys:
                    raise ValueError(
                        f"metric {metric.name!r} re-registered with "
                        f"different tag_keys {metric.tag_keys} != "
                        f"{existing.tag_keys}")
                if isinstance(metric, Histogram) \
                        and metric.boundaries != existing.boundaries:
                    raise ValueError(
                        f"histogram {metric.name!r} re-registered with "
                        f"different boundaries (shared bucket counts "
                        f"would corrupt)")
                # same metric constructed again (e.g. once per task body):
                # share the existing state so counts accumulate instead of
                # resetting with each construction
                metric._values = existing._values
                metric._lock = existing._lock
                if isinstance(metric, Histogram):
                    metric._counts = existing._counts
                    metric._sums = existing._sums
                    metric._ns = existing._ns
                return
            self._metrics[metric.name] = metric

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {name: m._export() for name, m in self._metrics.items()}

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


_registry = _Registry()


def snapshot() -> Dict[str, dict]:
    """This process's current metric values (wire form)."""
    return _registry.snapshot()


def clear_registry() -> None:
    _registry.clear()


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._lock = threading.Lock()
        self._values: Dict[Tuple, float] = {}
        self._default_tags: Dict[str, str] = {}
        _registry.register(self)

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple:
        merged = {**self._default_tags, **(tags or {})}
        return tuple(merged.get(k, "") for k in self.tag_keys)

    def _export(self) -> dict:
        raise NotImplementedError


class Counter(Metric):
    """Monotonically increasing count (aggregated by SUM across workers)."""

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        key = self._key(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def _export(self) -> dict:
        with self._lock:
            return {"type": "counter", "desc": self.description,
                    "tag_keys": self.tag_keys,
                    "values": {k: v for k, v in self._values.items()}}


class Gauge(Metric):
    """Point-in-time value (aggregated by LAST-WRITE per worker)."""

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[self._key(tags)] = float(value)

    def _export(self) -> dict:
        with self._lock:
            return {"type": "gauge", "desc": self.description,
                    "tag_keys": self.tag_keys,
                    "values": {k: v for k, v in self._values.items()}}


class Histogram(Metric):
    """Bucketed distribution (per-bucket counts SUM across workers)."""

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = _DEFAULT_BOUNDS,
                 tag_keys: Sequence[str] = ()):
        self.boundaries = tuple(sorted(boundaries))
        # containers BEFORE register (which may swap in shared state from
        # an earlier same-name registration — see _Registry.register)
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._ns: Dict[Tuple, int] = {}
        super().__init__(name, description, tag_keys)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        key = self._key(tags)
        idx = bisect.bisect_left(self.boundaries, value)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._ns[key] = self._ns.get(key, 0) + 1

    def _export(self) -> dict:
        with self._lock:
            return {"type": "histogram", "desc": self.description,
                    "tag_keys": self.tag_keys,
                    "boundaries": self.boundaries,
                    "values": {k: {"counts": list(c),
                                   "sum": self._sums.get(k, 0.0),
                                   "n": self._ns.get(k, 0)}
                               for k, c in self._counts.items()}}


# -- built-in runtime metrics (constructed on first use; the registry
# shares state across repeat constructions, so call sites just call these)

def submit_to_start_histogram() -> Histogram:
    """Seconds from task submit (driver/worker stamped submit_ts) to
    execution start at the worker — scheduler + queueing + transport,
    observed worker-side (reference: ray scheduler placement-time
    metrics). The companion scheduler-phase span carries the same value
    per task; this is the aggregate view."""
    return Histogram(
        "submit_to_start",
        description="seconds from task submit to worker execution start")


def queue_depth_gauge() -> Gauge:
    """Tasks waiting for a lease slot in this process's submitters
    (driver-side view of scheduler backlog)."""
    return Gauge("queue_depth",
                 description="tasks pending without an assigned lease")


def serve_request_latency_histogram() -> Histogram:
    """Per-deployment request latency, submit at the router to reply
    landed (reference: serve_deployment_processing_latency_ms — here in
    seconds, observed caller-side so it includes queueing + transport).
    Tagged with the request outcome (ok/timeout/retry/error) so p99
    stops silently excluding the worst cases: timed-out and retried
    requests observe too — and with the retry attempt number (""
    for first tries), so a backoff storm is visible as an attempt
    distribution rather than a mush of retry latencies."""
    return Histogram(
        "serve_request_latency_s",
        description="seconds from router submit to replica reply",
        tag_keys=("deployment", "outcome", "attempt"))


def serve_inflight_gauge() -> Gauge:
    """Requests this process has routed to a deployment and not yet seen
    complete (the router's own pow-2 in-flight estimate, summed across
    replicas)."""
    return Gauge("serve_inflight_requests",
                 description="in-flight requests per deployment",
                 tag_keys=("deployment",))


def serve_overload_shed_total_counter() -> Counter:
    """Requests re-routed to the cheaper shed model by the overload
    degradation ladder (serve/controller.py 'slo' policy at max level).
    A non-zero rate is the signature of a storm survived by degrading
    instead of queue collapse."""
    return Counter("serve_overload_shed_total",
                   description="requests shed to the overload fallback "
                               "model",
                   tag_keys=("deployment",))


def serve_slo_attainment_gauge() -> Gauge:
    """Windowed SLO attainment the serving control loop last acted on
    (fraction of finished requests in serve_slo_window_s meeting both
    TTFT and TPOT targets) — the controller-side view, distinct from the
    engine-lifetime llm_slo_*_attainment gauges."""
    return Gauge("serve_slo_attainment",
                 description="windowed fraction of requests meeting both "
                             "latency SLOs (0..1)",
                 tag_keys=("deployment",))


def train_step_time_gauge() -> Gauge:
    """Wall seconds between consecutive train.report calls on rank 0 —
    the step clock every throughput/MFU number derives from (reference:
    TorchTitan's built-in step-time telemetry as production table
    stakes)."""
    return Gauge("train_step_time_s",
                 description="seconds per training step (rank 0)")


def train_throughput_gauge() -> Gauge:
    """Steps per second (rank 0); multiply by the run's tokens-per-step
    for token throughput."""
    return Gauge("train_steps_per_s",
                 description="training steps per second (rank 0)")


def train_mfu_gauge() -> Gauge:
    """Model FLOPs utilization in [0, 1]: reported flops-per-step over
    step_time x peak hardware FLOPs. Only emitted when the loop reports
    a `flops_per_step` metric and peak FLOPs is known (RTPT_PEAK_FLOPS
    env or a `peak_flops` metric)."""
    return Gauge("train_mfu",
                 description="model FLOPs utilization (0..1, rank 0)")


def train_phase_time_gauge() -> Gauge:
    """Per-phase share of the train step (rank 0), tagged
    phase=forward|backward|optimizer|collective_wait — the attribution
    that makes the MFU plateau diagnosable (train.step_profiler, or a
    loop reporting a `phases` dict through train.report)."""
    return Gauge("train_phase_time_s",
                 description="seconds per step spent in each train phase "
                             "(rank 0)",
                 tag_keys=("phase",))


def train_phase_skew_gauge() -> Gauge:
    """Cross-host straggler attribution (rank 0): how many seconds each
    host's train phase ran BEHIND the fastest host that step, tagged
    {phase, host}. A host whose factor over the fastest exceeds
    `train_straggler_factor` also lands a `train_straggler` event in the
    cluster journal naming it (the 'which host is dragging the gang'
    question TorchTitan-scale multi-slice runs ask first)."""
    return Gauge("train_phase_skew_s",
                 description="seconds each host's train phase lags the "
                             "fastest host (rank 0 comparison)",
                 tag_keys=("phase", "host"))


def profile_samples_total_counter() -> Counter:
    """Thread-stack samples folded by this process's continuous
    wall-clock profiler (util/stack_profiler.py) — the denominator every
    collapsed-stack count is a share of."""
    return Counter("profile_samples_total",
                   description="stack samples folded by the continuous "
                               "profiler")


def profile_dropped_samples_total_counter() -> Counter:
    """Samples dropped because the bounded collapsed-stack table was
    full (profile_table_size distinct stacks). Non-zero means the
    profile under-reports cold stacks — raise the table size or flush
    more often; hot frames are unaffected."""
    return Counter("profile_dropped_samples_total",
                   description="profiler samples dropped on stack-table "
                               "overflow")


def log_records_total_counter() -> Counter:
    """Structured log records emitted by this process's log plane
    (util/log_plane.py), by severity — the denominator the drop counter
    is measured against."""
    return Counter("log_records_total",
                   description="structured log records emitted",
                   tag_keys=("level",))


def log_dropped_records_total_counter() -> Counter:
    """Records dropped on ring overflow (log_ring_records) before the
    telemetry flush shipped them. The file sink still has them; only the
    head-side queryable ring under-reports — and by exactly this much
    (emitted == stored + dropped)."""
    return Counter("log_dropped_records_total",
                   description="log records dropped on ring overflow")


def log_errors_total_counter() -> Counter:
    """Error-severity records by message fingerprint (digits/ids
    normalized out, so one bug is one fingerprint across a thousand
    instances; the per-process tag space is capped, long tail folds into
    'other')."""
    return Counter("log_errors_total",
                   description="error log records by message fingerprint",
                   tag_keys=("fingerprint",))


def xla_compile_seconds_histogram() -> Histogram:
    """Seconds spent in one XLA compile, as measured by the tracker
    (util/compile_tracker.py): the summed /jax/core/compile/* phase
    durations jax.monitoring attributed to the call when available,
    else the wall time of the call that compiled. The distribution's
    tail is the 'first step after a shape change' stall users feel."""
    return Histogram(
        "xla_compile_seconds",
        description="seconds per XLA compile (monitoring-attributed "
                    "phases, else compiling-call wall time)",
        boundaries=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0,
                    120.0))


def xla_compiles_total_counter() -> Counter:
    """XLA compiles observed by this process's tracker, by process role
    and kind — 'jit' for compiles caught at the wrap seam (named, with
    signatures), monitoring phase names (backend_compile, jaxpr_trace,
    jaxpr_to_mlir_module) for unattributed activity. A growing
    backend_compile count with a flat jit count means compiles are
    happening outside any wrapped callable — wrap it."""
    return Counter("xla_compiles_total",
                   description="XLA compiles by process role and kind",
                   tag_keys=("process", "kind"))


def xla_recompiles_total_counter() -> Counter:
    """Compiles of a callable that ALREADY had a compiled signature —
    i.e. cache misses caused by shape/dtype churn, the compiles the
    ragged/padded designs exist to avoid. Non-zero in steady state is
    the bug; the per-record signature diff in 'compiles' names the
    argument that moved."""
    return Counter("xla_recompiles_total",
                   description="XLA recompiles (same callable, new arg "
                               "signature)")


def train_checkpoint_write_seconds_histogram() -> Histogram:
    """Wall seconds of one host's checkpoint shard write (serialize +
    upload, measured on the background writer thread — the time the
    TRAINING thread does NOT pay when async saves overlap compute)."""
    return Histogram(
        "train_checkpoint_write_seconds",
        description="seconds to serialize and upload one host's "
                    "checkpoint shard (background writer)")


def train_checkpoint_write_bytes_counter() -> Counter:
    """Bytes of checkpoint shard data this host uploaded. Per-host by
    construction — comparing it against the full tree size is the proof
    that no single host serialized everything."""
    return Counter(
        "train_checkpoint_write_bytes",
        description="checkpoint shard bytes written by this host")


def train_checkpoint_queue_depth_count() -> Gauge:
    """In-flight async checkpoint saves queued behind the writer thread
    (bounded at 1: a save arriving while one is in flight blocks the
    training thread until the slot frees)."""
    return Gauge(
        "train_checkpoint_queue_depth_count",
        description="async checkpoint saves in flight (bounded queue)")


def train_checkpoint_step_hiccup_seconds_gauge() -> Gauge:
    """Max step time observed while an async save was in flight MINUS
    the median steady-state step time — the direct 'does checkpointing
    hiccup training' number (TorchTitan's flat-step-time criterion)."""
    return Gauge(
        "train_checkpoint_step_hiccup_seconds",
        description="max in-flight-save step time minus steady-state "
                    "median (rank 0)")


def storage_retry_total_counter() -> Counter:
    """Transient-error retries inside the storage seam, tagged by op —
    a rising rate is the early-warning for a degrading store."""
    return Counter("storage_retry_total",
                   description="storage-seam transient-error retries",
                   tag_keys=("op",))


def storage_op_seconds_histogram() -> Histogram:
    """End-to-end storage-seam op latency (including retries/backoff),
    tagged by op."""
    return Histogram("storage_op_seconds",
                     description="storage filesystem op seconds "
                                 "(including retries)",
                     tag_keys=("op",))


def storage_put_bytes_counter() -> Counter:
    """Bytes published through the storage seam (checkpoint shards,
    workflow state, spill files)."""
    return Counter("storage_put_bytes",
                   description="bytes written through the storage seam")


def llm_kv_page_utilization_gauge() -> Gauge:
    """Fraction of the paged KV pool's allocatable pages (all but the
    scratch page) currently held by sequences or the prefix cache."""
    return Gauge("llm_kv_page_utilization",
                 description="KV cache page utilization (0..1)")


def llm_prefix_hit_rate_gauge() -> Gauge:
    """Cumulative fraction of prompt tokens served from cached prefix
    pages instead of being prefilled (vLLM's prefix-cache hit rate, by
    tokens not lookups — the number that predicts TTFT savings)."""
    return Gauge("llm_prefix_cache_hit_rate",
                 description="prompt tokens served from the prefix "
                             "cache / total prompt tokens (0..1)")


def llm_prefill_tokens_per_s_gauge() -> Gauge:
    """Prompt tokens prefilled per second (fast-path groups + chunked
    tails), over the engine's ~1s gauge window."""
    return Gauge("llm_prefill_tokens_per_s",
                 description="prompt tokens prefilled per second")


def llm_decode_tokens_per_s_gauge() -> Gauge:
    """Tokens decoded per second across the running batch, over the
    engine's ~1s gauge window."""
    return Gauge("llm_decode_tokens_per_s",
                 description="tokens decoded per second (whole batch)")


def llm_queue_depth_gauge() -> Gauge:
    """Requests waiting for admission into the engine (not yet holding
    a slot) — the backpressure signal for serve autoscaling."""
    return Gauge("llm_queue_depth",
                 description="LLM requests waiting for admission")


def llm_compiled_programs_gauge() -> Gauge:
    """Distinct LLM step programs dispatched in this process (ragged
    mixed step + decode loop + COW page copy, each per signature of its
    arguments: the counterpart of the JAX engine's jit cache entries).
    O(1) by design — a rise means the engine started dispatching new
    shapes, the regression the ragged single-dispatch step exists to
    prevent."""
    return Gauge("llm_compiled_step_programs",
                 description="compiled LLM step programs resident")


def llm_dispatches_per_step_gauge() -> Gauge:
    """Device dispatches per scheduler step over the gauge window
    (ragged mixed steps + decode loops + COW copies). The steady-state
    target is 1.0: each step is ONE program launch."""
    return Gauge("llm_dispatches_per_step",
                 description="device dispatches per engine step")


def llm_padding_waste_gauge() -> Gauge:
    """Fraction of ragged-step token slots that carried padding instead
    of real prompt/decode tokens, over the gauge window — the cost of
    the fixed ragged shape; high values say shrink prefill_rows or
    prefill_chunk for this workload."""
    return Gauge("llm_ragged_padding_waste",
                 description="padding fraction of ragged step token "
                             "slots (0..1)")


# Serving-latency buckets: sub-ms (cache hit / queue-free admit) up to
# 30s (page-pressure starvation); TPOT gets a finer low end, e2e a
# longer tail. vLLM exposes the same trio of request histograms.
_LLM_LATENCY_BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                       0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
_LLM_TPOT_BOUNDS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.075, 0.1, 0.25, 0.5, 1.0)
_LLM_E2E_BOUNDS = _LLM_LATENCY_BOUNDS + (60.0, 120.0)


def llm_ttft_seconds_histogram() -> Histogram:
    """Time to first token: enqueue at the engine to the first sampled
    token (queue wait + prefill), per finished request."""
    return Histogram("llm_ttft_seconds",
                     description="seconds from request enqueue to first "
                                 "generated token",
                     boundaries=_LLM_LATENCY_BOUNDS)


def llm_tpot_seconds_histogram() -> Histogram:
    """Time per output token after the first: (last_token_ts -
    first_token_ts) / (n_generated - 1), the mean inter-token latency of
    a finished request (vLLM TPOT)."""
    return Histogram("llm_tpot_seconds",
                     description="mean seconds per output token after "
                                 "the first",
                     boundaries=_LLM_TPOT_BOUNDS)


def llm_e2e_seconds_histogram() -> Histogram:
    """End-to-end request latency: enqueue to finish."""
    return Histogram("llm_e2e_seconds",
                     description="seconds from request enqueue to finish",
                     boundaries=_LLM_E2E_BOUNDS)


def llm_queue_wait_seconds_histogram() -> Histogram:
    """Admission queue wait: enqueue to first slot admission."""
    return Histogram("llm_queue_wait_seconds",
                     description="seconds from request enqueue to "
                                 "admission into a batch slot",
                     boundaries=_LLM_LATENCY_BOUNDS)


def llm_slo_ttft_attainment_gauge() -> Gauge:
    """Fraction of finished requests whose TTFT met the configured
    llm_slo_ttft_ms target (1.0 until a request finishes)."""
    return Gauge("llm_slo_ttft_attainment",
                 description="fraction of requests meeting the TTFT SLO "
                             "(0..1)")


def llm_slo_tpot_attainment_gauge() -> Gauge:
    """Fraction of finished requests whose TPOT met the configured
    llm_slo_tpot_ms target (single-token requests count as met)."""
    return Gauge("llm_slo_tpot_attainment",
                 description="fraction of requests meeting the TPOT SLO "
                             "(0..1)")


def llm_preemptions_gauge() -> Gauge:
    """Cumulative decode preemptions (sequences that lost their pages
    under allocation pressure and re-queued for recompute) — vLLM's
    num_preemptions counter; sustained growth says the KV pool is
    undersized for the workload."""
    return Gauge("llm_preemptions_total",
                 description="cumulative decode preemptions (recompute "
                             "re-queues)")


def tune_running_trials_gauge() -> Gauge:
    """Trials currently holding an actor in this tuner process."""
    return Gauge("tune_running_trials",
                 description="trials currently running")


# -- object-plane accounting (reference: object store / object manager
# stats feeding `ray memory` and the object-store dashboard panels).
# Every series here follows <subsystem>_<noun>_<unit> with the unit in
# {bytes, seconds, total, count} — tests/test_state_cli.py lints the set.

def object_store_spill_write_total_counter() -> Counter:
    """Objects spilled to disk because the shm arena was full at seal
    (primaries are pinned, so eviction can't make room for them)."""
    return Counter("object_store_spill_write_total",
                   description="objects spilled to disk (arena full at "
                               "seal)")


def object_store_spill_write_bytes_counter() -> Counter:
    return Counter("object_store_spill_write_bytes",
                   description="serialized bytes written to spill files")


def object_store_spill_restore_total_counter() -> Counter:
    """Spilled objects read back (local get fallback or served to a
    remote puller)."""
    return Counter("object_store_spill_restore_total",
                   description="spill files read back to satisfy a get "
                               "or a remote pull")


def object_store_spill_restore_bytes_counter() -> Counter:
    return Counter("object_store_spill_restore_bytes",
                   description="bytes read back from spill files")


def object_store_pull_in_bytes_counter() -> Counter:
    """Object bytes fetched INTO this process from remote holders
    (whole-object reads + chunked pulls)."""
    return Counter("object_store_pull_in_bytes",
                   description="object bytes pulled in from remote nodes")


def object_store_pull_out_bytes_counter() -> Counter:
    """Object bytes this node daemon served OUT to remote pullers."""
    return Counter("object_store_pull_out_bytes",
                   description="object bytes served to remote pullers")


def object_store_pull_seconds_histogram() -> Histogram:
    """Whole-object pull latency (resolve reply to local availability),
    one observation per pulled object regardless of chunk count."""
    return Histogram("object_store_pull_seconds",
                     description="seconds to pull one object to the "
                                 "local node")


def object_store_fetch_inflight_count_gauge() -> Gauge:
    """Owner-resolve fetch loops currently running in this process."""
    return Gauge("object_store_fetch_inflight_count",
                 description="active object fetch loops")


def object_store_primary_count_gauge() -> Gauge:
    """Primary (pinned) copies this process sealed and still accounts."""
    return Gauge("object_store_primary_count",
                 description="live primary copies in this process's "
                             "directory")


def object_store_secondary_count_gauge() -> Gauge:
    """Secondary (pull-cache, LRU-evictable) copies still resident."""
    return Gauge("object_store_secondary_count",
                 description="live secondary (cache) copies in this "
                             "process's directory")


def object_store_spilled_count_gauge() -> Gauge:
    """Objects currently living only in spill files."""
    return Gauge("object_store_spilled_count",
                 description="objects currently resident only on disk")


def aggregate(per_worker: Dict[str, Dict[str, dict]]) -> Dict[str, dict]:
    """Merge worker snapshots: counters/histograms sum, gauges last-write.
    (head-side; reference: metrics agent → Prometheus aggregation)."""
    out: Dict[str, dict] = {}
    for worker, snap in sorted(per_worker.items()):
        for name, m in snap.items():
            cur = out.get(name)
            if cur is None:
                import copy
                out[name] = copy.deepcopy(m)
                continue
            if m["type"] == "counter":
                for k, v in m["values"].items():
                    cur["values"][k] = cur["values"].get(k, 0.0) + v
            elif m["type"] == "gauge":
                cur["values"].update(m["values"])
            elif m["type"] == "histogram":
                for k, v in m["values"].items():
                    tgt = cur["values"].get(k)
                    if tgt is None:
                        cur["values"][k] = v
                    else:
                        tgt["counts"] = [a + b for a, b in
                                         zip(tgt["counts"], v["counts"])]
                        tgt["sum"] += v["sum"]
                        tgt["n"] += v["n"]
    return out
