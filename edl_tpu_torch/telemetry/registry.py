"""Process-local metrics registry: counters, gauges, bounded histograms.

The port's own copy of ``edl_tpu/telemetry/registry.py`` (stdlib only),
reading the port's own catalog:

- **Catalog-strict**: a metric must be declared in ``catalog.CATALOG``
  (name, type, allowed label keys) before it can be emitted, so
  ``GET /metrics`` stays a stable exposition surface.
- **Bounded label cardinality**: each metric holds at most
  ``MAX_LABEL_SETS`` distinct label sets; further label sets collapse
  into one ``overflow="true"`` series.
- **Bounded histograms**: fixed bucket bounds declared in the catalog
  (default ``DEFAULT_BUCKETS``) — constant memory per series.
- **Prometheus text exposition** via ``render_prometheus``.
- **Mergeable snapshots**: ``merge_snapshots`` sums counters and
  histograms and maxes gauges: the coordinator's aggregator merges the
  cumulative per-source snapshots with it.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from edl_tpu_torch.telemetry.catalog import CATALOG

#: distinct label sets a single metric may hold before folding new
#: ones into the overflow series
MAX_LABEL_SETS = 64

#: default histogram bucket upper bounds (seconds)
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

_OVERFLOW_KEY = "overflow=true"


def _label_key(labels: Dict[str, object]) -> str:
    """Canonical series key: sorted ``k=v`` pairs joined by ``|``
    (empty string = the unlabeled series)."""
    if not labels:
        return ""
    return "|".join(f"{k}={labels[k]}" for k in sorted(labels))


def parse_label_key(key: str) -> List[Tuple[str, str]]:
    if not key:
        return []
    return [tuple(part.split("=", 1)) for part in key.split("|")]


class _Hist:
    """One histogram series: fixed buckets, per-bucket counts, sum."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def to_dict(self) -> dict:
        return {
            "buckets": list(self.buckets),
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
        }


class _Metric:
    __slots__ = ("name", "mtype", "labels_allowed", "buckets", "series")

    def __init__(self, name, mtype, labels_allowed, buckets):
        self.name = name
        self.mtype = mtype
        self.labels_allowed = labels_allowed
        self.buckets = buckets
        self.series: Dict[str, object] = {}


class _Handle:
    """Bound (registry, metric) pair — the object call sites cache so
    the hot loop pays zero name lookups."""

    __slots__ = ("_reg", "_m")

    def __init__(self, reg: "MetricsRegistry", m: _Metric):
        self._reg = reg
        self._m = m

    def _series_key(self, labels: Dict[str, object]) -> str:
        m = self._m
        if self._reg.strict and labels:
            for k in labels:
                if k not in m.labels_allowed:
                    raise ValueError(
                        f"metric {m.name!r} does not declare label "
                        f"{k!r} (allowed: {m.labels_allowed})"
                    )
        key = _label_key(labels)
        if key not in m.series and len(m.series) >= self._reg.max_label_sets:
            return _OVERFLOW_KEY
        return key


class Counter(_Handle):
    def inc(self, n: float = 1.0, **labels) -> None:
        with self._reg._lock:
            key = self._series_key(labels)
            self._m.series[key] = self._m.series.get(key, 0.0) + n

    def value(self, **labels) -> float:
        with self._reg._lock:
            return float(self._m.series.get(_label_key(labels), 0.0))


class Gauge(_Handle):
    def set(self, v: float, **labels) -> None:
        with self._reg._lock:
            self._m.series[self._series_key(labels)] = float(v)

    def value(self, **labels) -> float:
        with self._reg._lock:
            return float(self._m.series.get(_label_key(labels), 0.0))


class Histogram(_Handle):
    def observe(self, v: float, **labels) -> None:
        with self._reg._lock:
            key = self._series_key(labels)
            h = self._m.series.get(key)
            if h is None:
                h = self._m.series[key] = _Hist(self._m.buckets)
            h.observe(float(v))

    def series(self, **labels) -> Optional[dict]:
        with self._reg._lock:
            h = self._m.series.get(_label_key(labels))
            return h.to_dict() if h is not None else None


_HANDLE_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Thread-safe metric store.  ``strict`` (the default) admits only
    catalog-declared names/types/label keys."""

    def __init__(
        self, strict: bool = True, max_label_sets: int = MAX_LABEL_SETS
    ):
        self._lock = threading.Lock()
        self.strict = strict
        self.max_label_sets = max_label_sets
        self._metrics: Dict[str, _Metric] = {}
        self._handles: Dict[str, _Handle] = {}

    def _metric(self, name: str, mtype: str, buckets=None) -> _Handle:
        with self._lock:
            h = self._handles.get(name)
            if h is not None:
                if self._metrics[name].mtype != mtype:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{self._metrics[name].mtype}, not {mtype}"
                    )
                return h
            spec = CATALOG.get(name)
            if self.strict:
                if spec is None:
                    raise ValueError(
                        f"metric {name!r} is not in the catalog "
                        "(edl_tpu_torch/telemetry/catalog.py) — register "
                        "it there or use a non-strict registry"
                    )
                if spec["type"] != mtype:
                    raise ValueError(
                        f"metric {name!r} is cataloged as "
                        f"{spec['type']}, not {mtype}"
                    )
            labels_allowed = tuple(spec["labels"]) if spec else ()
            if buckets is None:
                buckets = (
                    tuple(spec["buckets"])
                    if spec and "buckets" in spec
                    else DEFAULT_BUCKETS
                )
            m = _Metric(name, mtype, labels_allowed, tuple(buckets))
            self._metrics[name] = m
            h = self._handles[name] = _HANDLE_TYPES[mtype](self, m)
            return h

    def counter(self, name: str) -> Counter:
        return self._metric(name, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._metric(name, "gauge")

    def histogram(self, name: str, buckets=None) -> Histogram:
        return self._metric(name, "histogram", buckets=buckets)

    def snapshot(self) -> dict:
        """JSON-safe cumulative snapshot."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            for name, m in self._metrics.items():
                if m.mtype == "counter":
                    out["counters"][name] = dict(m.series)
                elif m.mtype == "gauge":
                    out["gauges"][name] = dict(m.series)
                else:
                    out["histograms"][name] = {
                        k: h.to_dict() for k, h in m.series.items()
                    }
        return out

    def render(self) -> str:
        return render_prometheus(self.snapshot())


def merge_snapshots(snaps: Sequence[dict]) -> dict:
    """Merge cumulative per-source snapshots into one cluster view:
    counters and histograms SUM (each source counted once — the caller
    keys sources and passes the latest snapshot per source, which is
    what makes re-delivery idempotent); gauges take the MAX (they are
    world-consistent values like the generation, where max = newest)."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for s in snaps:
        if not s:
            continue
        for name, series in (s.get("counters") or {}).items():
            dst = out["counters"].setdefault(name, {})
            for k, v in series.items():
                dst[k] = dst.get(k, 0.0) + v
        for name, series in (s.get("gauges") or {}).items():
            dst = out["gauges"].setdefault(name, {})
            for k, v in series.items():
                dst[k] = max(dst.get(k, float("-inf")), v)
        for name, series in (s.get("histograms") or {}).items():
            dst = out["histograms"].setdefault(name, {})
            for k, h in series.items():
                d = dst.get(k)
                if d is None:
                    dst[k] = {
                        "buckets": list(h["buckets"]),
                        "counts": list(h["counts"]),
                        "sum": h["sum"],
                        "count": h["count"],
                    }
                elif list(d["buckets"]) == list(h["buckets"]):
                    d["counts"] = [
                        a + b for a, b in zip(d["counts"], h["counts"])
                    ]
                    d["sum"] += h["sum"]
                    d["count"] += h["count"]
                else:  # bucket-schema skew (rolling upgrade): keep sums
                    d["sum"] += h["sum"]
                    d["count"] += h["count"]
    return out


def _fmt_labels(pairs: List[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    body = ",".join(
        '{}="{}"'.format(
            k, str(v).replace("\\", "\\\\").replace('"', '\\"')
        )
        for k, v in pairs
    )
    return "{" + body + "}"


def _fmt_num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def render_prometheus(snapshot: dict) -> str:
    """Prometheus text exposition (format 0.0.4) of a snapshot."""
    lines: List[str] = []

    def head(name: str, mtype: str) -> None:
        spec = CATALOG.get(name)
        if spec is not None:
            lines.append(f"# HELP {name} {spec['help']}")
        lines.append(f"# TYPE {name} {mtype}")

    for name in sorted(snapshot.get("counters") or {}):
        head(name, "counter")
        for k in sorted(snapshot["counters"][name]):
            lines.append(
                f"{name}{_fmt_labels(parse_label_key(k))} "
                f"{_fmt_num(snapshot['counters'][name][k])}"
            )
    for name in sorted(snapshot.get("gauges") or {}):
        head(name, "gauge")
        for k in sorted(snapshot["gauges"][name]):
            lines.append(
                f"{name}{_fmt_labels(parse_label_key(k))} "
                f"{_fmt_num(snapshot['gauges'][name][k])}"
            )
    for name in sorted(snapshot.get("histograms") or {}):
        head(name, "histogram")
        for k in sorted(snapshot["histograms"][name]):
            h = snapshot["histograms"][name][k]
            base = parse_label_key(k)
            cum = 0
            for le, c in zip(h["buckets"], h["counts"]):
                cum += c
                lines.append(
                    f"{name}_bucket"
                    f"{_fmt_labels(base + [('le', _fmt_num(le))])} {cum}"
                )
            cum += h["counts"][-1]
            lines.append(
                f"{name}_bucket{_fmt_labels(base + [('le', '+Inf')])} {cum}"
            )
            lines.append(
                f"{name}_sum{_fmt_labels(base)} {_fmt_num(h['sum'])}"
            )
            lines.append(f"{name}_count{_fmt_labels(base)} {h['count']}")
    return "\n".join(lines) + ("\n" if lines else "")
