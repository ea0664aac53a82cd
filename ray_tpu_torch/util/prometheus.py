"""Prometheus text exposition (format 0.0.4) over ray_tpu_torch metrics.

Role-equivalent to the reference's metrics-agent -> Prometheus exporter
(reference: ray's OpenCensus stats exporter feeding the head's /metrics
scrape endpoint): renders the head's aggregated application metrics
(util/metrics.py families, tag tuples intact) plus the hardware
time-series store's latest samples into the text format every scraper
speaks — `# HELP`/`# TYPE` per family, label escaping per the spec, and
histograms as CUMULATIVE `_bucket{le=...}` counts with `_sum`/`_count`
(our util/metrics.Histogram stores per-bucket counts, so the renderer
does the running sum).

The port of ``ray_tpu/util/prometheus.py``: plain text, no client
package.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_FIX = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_FIX = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_name(name: str) -> str:
    if _NAME_OK.match(name):
        return name
    name = _NAME_FIX.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _label_key(key: str) -> str:
    key = _LABEL_FIX.sub("_", key) or "_"
    if key[0].isdigit():
        key = "_" + key
    return key


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(value: float) -> str:
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _labels(keys, values, extra: Optional[Dict[str, str]] = None) -> str:
    pairs = [(k, v) for k, v in zip(keys, values)]
    if extra:
        pairs += list(extra.items())
    if not pairs:
        return ""
    body = ",".join(f'{_label_key(k)}="{_escape(v)}"' for k, v in pairs)
    return "{" + body + "}"


def _bucket_labels(keys, values, le: str) -> str:
    pairs = [(k, v) for k, v in zip(keys, values)] + [("le", le)]
    body = ",".join(f'{_label_key(k)}="{_escape(v)}"' for k, v in pairs)
    return "{" + body + "}"


def render_metrics(agg: Dict[str, dict]) -> List[str]:
    """Lines for an aggregated metrics table (util/metrics.aggregate
    output with tuple value-keys, i.e. metrics_dump(raw=True))."""
    lines: List[str] = []
    for name in sorted(agg):
        m = agg[name]
        pname = sanitize_name(name)
        mtype = m.get("type", "gauge")
        if mtype not in ("counter", "gauge", "histogram"):
            continue
        desc = (m.get("desc") or "").replace("\\", "\\\\").replace(
            "\n", "\\n")
        if desc:
            lines.append(f"# HELP {pname} {desc}")
        lines.append(f"# TYPE {pname} {mtype}")
        keys = tuple(m.get("tag_keys") or ())
        values = m.get("values") or {}
        for vkey in sorted(values, key=str):
            tag_vals = vkey if isinstance(vkey, (tuple, list)) else (vkey,)
            if mtype in ("counter", "gauge"):
                lines.append(
                    f"{pname}{_labels(keys, tag_vals)} "
                    f"{_fmt(values[vkey])}")
                continue
            # histogram: stored counts are PER-bucket; exposition wants
            # the cumulative count at each upper bound, then +Inf == n
            h = values[vkey]
            bounds = m.get("boundaries") or ()
            running = 0
            for i, bound in enumerate(bounds):
                running += h["counts"][i] if i < len(h["counts"]) else 0
                lines.append(
                    f"{pname}_bucket"
                    f"{_bucket_labels(keys, tag_vals, _fmt(float(bound)))} "
                    f"{running}")
            lines.append(
                f"{pname}_bucket"
                f"{_bucket_labels(keys, tag_vals, '+Inf')} {h['n']}")
            lines.append(
                f"{pname}_sum{_labels(keys, tag_vals)} {_fmt(h['sum'])}")
            lines.append(
                f"{pname}_count{_labels(keys, tag_vals)} {h['n']}")
    return lines


def render_hardware(latest: List[dict]) -> List[str]:
    """Lines for the hardware time-series store's newest samples
    (TimeSeriesStore.latest()): every series becomes a gauge with a
    `node` label plus the sample's own tags."""
    lines: List[str] = []
    by_metric: Dict[str, List[dict]] = {}
    for s in latest:
        by_metric.setdefault(s["metric"], []).append(s)
    for metric in sorted(by_metric):
        pname = sanitize_name(metric)
        lines.append(f"# TYPE {pname} gauge")
        for s in by_metric[metric]:
            extra = {"node": s["node"][:12], **(s.get("tags") or {})}
            lines.append(
                f"{pname}{_labels((), (), extra)} {_fmt(s['value'])}")
    return lines


def render(agg: Dict[str, dict],
           hardware_latest: Optional[List[dict]] = None) -> str:
    lines = render_metrics(agg)
    if hardware_latest:
        lines += render_hardware(hardware_latest)
    return "\n".join(lines) + "\n" if lines else ""


def parse(text: str) -> Dict[str, dict]:
    """Parse exposition text back into {family: {type, samples}} — the
    golden-test half of the round trip (not a full openmetrics parser:
    enough to verify families, labels, and cumulative buckets).
    samples: list of (name, {label: value}, float)."""
    families: Dict[str, dict] = {}
    types: Dict[str, str] = {}
    sample_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)$")
    label_re = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            fam, _, mtype = rest.partition(" ")
            types[fam] = mtype.strip()
            families.setdefault(fam, {"type": mtype.strip(), "samples": []})
            continue
        if line.startswith("#"):
            continue
        m = sample_re.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, _, labelstr, value = m.groups()
        labels = {}
        for lk, lv in label_re.findall(labelstr or ""):
            labels[lk] = (lv.replace('\\"', '"').replace("\\n", "\n")
                          .replace("\\\\", "\\"))
        fam = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in types \
                    and types[name[:-len(suffix)]] == "histogram":
                fam = name[:-len(suffix)]
                break
        v = float(value) if value not in ("+Inf", "-Inf", "NaN") else \
            {"+Inf": math.inf, "-Inf": -math.inf, "NaN": math.nan}[value]
        families.setdefault(fam, {"type": types.get(fam, "untyped"),
                                  "samples": []})
        families[fam]["samples"].append((name, labels, v))
    return families
