"""Head-side hardware time series: fixed-size ring buffers.

Role-equivalent to the reference's metrics-agent retention window
(reference: dashboard metrics agent buffering node/GPU samples before the
Prometheus scrape): each (node, metric, tags) series keeps the last N
points in a deque ring — appends are O(1), memory is bounded by
``maxlen * max_series`` regardless of cluster age. The head feeds this
from `telemetry_push` samples; `timeseries_dump` and the dashboard's
`/api/timeseries` + `/metrics` read it.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

#: series key: (node_id, metric_name, sorted (k,v) tag pairs)
_Key = Tuple[str, str, Tuple[Tuple[str, str], ...]]


class TimeSeriesStore:
    """Bounded per-series rings with LRU eviction of whole series.

    Two bounds, both hard: `maxlen` points per series (the ring) and
    `max_series` distinct series (worker churn mints new tag sets
    forever; without the cap a long-lived head leaks a ring per dead
    worker)."""

    def __init__(self, maxlen: int = 512, max_series: int = 4096):
        self.maxlen = max(1, int(maxlen))
        self.max_series = max(1, int(max_series))
        self._lock = threading.Lock()
        # OrderedDict gives LRU order: move_to_end on append, popitem(False)
        # evicts the longest-untouched series
        self._series: "collections.OrderedDict[_Key, collections.deque]" = \
            collections.OrderedDict()

    @staticmethod
    def _key(node: str, metric: str,
             tags: Optional[Dict[str, str]]) -> _Key:
        return (node, metric,
                tuple(sorted((str(k), str(v))
                             for k, v in (tags or {}).items())))

    def append(self, node: str, metric: str, value: float,
               ts: Optional[float] = None,
               tags: Optional[Dict[str, str]] = None) -> None:
        key = self._key(node, metric, tags)
        point = (float(ts if ts is not None else time.time()), float(value))
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                ring = collections.deque(maxlen=self.maxlen)
                self._series[key] = ring
            ring.append(point)
            self._series.move_to_end(key)
            while len(self._series) > self.max_series:
                self._series.popitem(last=False)

    def ingest(self, node: str, samples) -> int:
        """Append a telemetry batch: [{metric, value, ts?, tags?}, ...].
        Malformed entries are skipped (telemetry must never raise into
        the push RPC). Returns the number accepted."""
        n = 0
        for s in samples or ():
            try:
                self.append(node, s["metric"], s["value"],
                            ts=s.get("ts"), tags=s.get("tags"))
                n += 1
            except (KeyError, TypeError, ValueError):
                continue
        return n

    def dump(self, node: str = "", metric: str = "",
             last: int = 0) -> List[dict]:
        """Series matching the (prefix) filters, oldest point first."""
        out = []
        with self._lock:
            items = [(k, list(ring)) for k, ring in self._series.items()]
        for (n_id, m_name, tag_items), points in items:
            if node and not n_id.startswith(node):
                continue
            if metric and m_name != metric:
                continue
            if last > 0:
                points = points[-last:]
            out.append({"node": n_id, "metric": m_name,
                        "tags": dict(tag_items), "points": points})
        out.sort(key=lambda s: (s["metric"], s["node"]))
        return out

    def latest(self, max_age_s: float = 0.0) -> List[dict]:
        """The newest point of every series (for gauge exposition);
        series whose last point is older than max_age_s are skipped
        (dead nodes must not export frozen gauges forever)."""
        cutoff = time.time() - max_age_s if max_age_s > 0 else None
        out = []
        with self._lock:
            for (n_id, m_name, tag_items), ring in self._series.items():
                if not ring:
                    continue
                ts, value = ring[-1]
                if cutoff is not None and ts < cutoff:
                    continue
                out.append({"node": n_id, "metric": m_name,
                            "tags": dict(tag_items),
                            "ts": ts, "value": value})
        out.sort(key=lambda s: (s["metric"], s["node"]))
        return out

    def num_series(self) -> int:
        with self._lock:
            return len(self._series)
