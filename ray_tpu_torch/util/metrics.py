"""Application metrics: Counter / Gauge / Histogram — the port's own copy
of ``ray_tpu/util/metrics.py``: the per-process registry, the three metric
types, and the factories the port calls (the train step gauges, the log
plane's counters, the LLM engine's gauges, the flight recorder's
histograms and Tune's running-trials gauge). Metrics register in this process's registry; ``snapshot()``
reads it in the JAX package's wire form.
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


# -- built-in metrics the port emits (constructed on first use; the
# registry shares state across repeat constructions, so call sites just
# call these)


def train_step_time_gauge() -> Gauge:
    """Seconds per train step (rank 0; here set by the step profiler) —
    the step clock every throughput/MFU number derives from."""
    return Gauge("train_step_time_s",
                 description="seconds per training step (rank 0)")


def train_phase_time_gauge() -> Gauge:
    """Per-phase share of the train step (rank 0), tagged
    phase=forward|backward|optimizer|collective_wait — the attribution
    that makes the MFU plateau diagnosable (train.step_profiler)."""
    return Gauge("train_phase_time_s",
                 description="seconds per step spent in each train phase "
                             "(rank 0)",
                 tag_keys=("phase",))


def tune_running_trials_gauge() -> Gauge:
    """Trials currently holding an actor in this tuner process."""
    return Gauge("tune_running_trials",
                 description="trials currently running")


def log_records_total_counter() -> Counter:
    """Structured log records emitted by this process's log plane
    (util/log_plane.py), by severity — the denominator the drop counter
    is measured against."""
    return Counter("log_records_total",
                   description="structured log records emitted",
                   tag_keys=("level",))


def log_dropped_records_total_counter() -> Counter:
    """Records dropped on ring overflow (log_plane.RING_RECORDS) before a drain
    exported them — by exactly this much (emitted == stored + dropped)."""
    return Counter("log_dropped_records_total",
                   description="log records dropped on ring overflow")


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
