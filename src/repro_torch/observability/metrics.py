"""Metrics registry: counters, gauges, fixed-bucket histograms with labeled
series, and a JSON-lines snapshot exporter (DESIGN.md §13).

One :class:`MetricsRegistry` holds named metrics; each metric holds one
*series* per label set (``impl="csr"``, ``tier="m56_z256"``, …), so the same
``spmm_dispatch_total`` counter fans out per implementation without
pre-declaring the label values. The registry is the shared substrate
``ServeMetrics``, the trainer hooks, and the kernel-dispatch spans all
report through — one ``snapshot()`` covers the whole process.

Histograms are **fixed-bucket** (cumulative-style ``le`` upper bounds like
Prometheus): ``observe()`` is O(#buckets) with no allocation, and the bucket
boundaries are part of the exporter schema (pinned by tests so downstream
dashboards can't drift silently). ``keep_samples=True`` additionally retains
raw samples (bounded) for EXACT percentiles — ``ServeMetrics`` uses this so
the serving p50/p99 stay sample-exact, not bucket-interpolated.

Snapshot rows are strict JSON (NaN → null via ``sanitize_json``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import threading

import numpy as np

from repro_torch.observability.trace import sanitize_json

# default latency-ish buckets (seconds): 1µs … 100s, multiplicative ~x4.64
DEFAULT_TIME_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0)
# how many raw samples a keep_samples=True histogram retains before it stops
# appending (count/sum/min/max/buckets stay exact; percentiles degrade to
# the retained prefix — sized far above any serve/train run we record)
SAMPLE_LIMIT = 100_000


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class _Metric:
    kind = "abstract"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._series: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _get(self, labels: dict, make):
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            with self._lock:
                s = self._series.setdefault(key, make())
        return s

    def labelsets(self) -> list[dict]:
        return [dict(k) for k in self._series]


class Counter(_Metric):
    """Monotonically increasing count (per label set)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name}: negative inc {value}")
        box = self._get(labels, lambda: [0.0])
        box[0] += value

    def value(self, **labels) -> float:
        box = self._series.get(_label_key(labels))
        return box[0] if box else 0.0

    def total(self) -> float:
        return sum(box[0] for box in self._series.values())

    def rows(self):
        for key, box in self._series.items():
            yield {"metric": self.name, "type": "counter",
                   "labels": dict(key), "value": box[0]}


class Gauge(_Metric):
    """Last-written value (per label set); ``nan`` until first set."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        box = self._get(labels, lambda: [float("nan")])
        box[0] = float(value)

    def add(self, value: float, **labels) -> None:
        box = self._get(labels, lambda: [float("nan")])
        box[0] = value if math.isnan(box[0]) else box[0] + value

    def value(self, **labels) -> float:
        box = self._series.get(_label_key(labels))
        return box[0] if box else float("nan")

    def rows(self):
        for key, box in self._series.items():
            yield {"metric": self.name, "type": "gauge",
                   "labels": dict(key), "value": box[0]}


@dataclasses.dataclass
class _HistSeries:
    counts: list          # per-bucket counts (+1 overflow bucket)
    n: int = 0
    total: float = 0.0
    vmin: float = float("inf")
    vmax: float = float("-inf")
    samples: list | None = None


class Histogram(_Metric):
    """Fixed-bucket histogram; ``le`` upper bounds + one +Inf overflow."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple[float, ...] = DEFAULT_TIME_BUCKETS,
                 keep_samples: bool = False):
        super().__init__(name, help)
        if tuple(sorted(buckets)) != tuple(buckets) or not buckets:
            raise ValueError(
                f"histogram {name}: buckets must be non-empty and ascending, "
                f"got {buckets}")
        self.buckets = tuple(float(b) for b in buckets)
        self.keep_samples = keep_samples

    def _make(self):
        return _HistSeries(
            counts=[0] * (len(self.buckets) + 1),
            samples=[] if self.keep_samples else None)

    def observe(self, value: float, **labels) -> None:
        s: _HistSeries = self._get(labels, self._make)
        v = float(value)
        i = 0
        for i, b in enumerate(self.buckets):   # noqa: B007 — small, fixed
            if v <= b:
                break
        else:
            i = len(self.buckets)
        s.counts[i] += 1
        s.n += 1
        s.total += v
        s.vmin = min(s.vmin, v)
        s.vmax = max(s.vmax, v)
        if s.samples is not None and len(s.samples) < SAMPLE_LIMIT:
            s.samples.append(v)

    def count(self, **labels) -> int:
        s = self._series.get(_label_key(labels))
        return s.n if s else 0

    def sum(self, **labels) -> float:
        s = self._series.get(_label_key(labels))
        return s.total if s else 0.0

    def percentile(self, p: float, **labels) -> float:
        """Sample-exact when ``keep_samples`` (numpy percentile over the raw
        samples); bucket-upper-bound otherwise. NaN for an empty series."""
        s: _HistSeries | None = self._series.get(_label_key(labels))
        if s is None or s.n == 0:
            return float("nan")
        if s.samples:
            return float(np.percentile(np.asarray(s.samples), p))
        target = p / 100.0 * s.n
        acc = 0
        for i, c in enumerate(s.counts):
            acc += c
            if acc >= target:
                return (self.buckets[i] if i < len(self.buckets)
                        else s.vmax)
        return s.vmax

    def rows(self):
        for key, s in self._series.items():
            yield {
                "metric": self.name, "type": "histogram",
                "labels": dict(key), "count": s.n, "sum": s.total,
                "min": s.vmin if s.n else float("nan"),
                "max": s.vmax if s.n else float("nan"),
                "buckets": [
                    {"le": b, "count": c}
                    for b, c in zip(self.buckets + (float("inf"),), s.counts)
                ],
            }


class MetricsRegistry:
    """Named metrics with get-or-create semantics and one shared snapshot.

    Re-registering a name returns the SAME metric object (so independent
    layers share series) but a kind mismatch raises — a counter silently
    shadowing a histogram is exactly the drift the registry exists to stop.
    """

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = DEFAULT_TIME_BUCKETS,
                  keep_samples: bool = False) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets,
                              keep_samples=keep_samples)

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> list[dict]:
        """Every labeled series as one flat row list, name-sorted."""
        rows: list[dict] = []
        for name in self.names():
            rows.extend(self._metrics[name].rows())
        return rows

    def export_jsonl(self, path: str | os.PathLike,
                     extra: dict | None = None) -> pathlib.Path:
        """One strict-JSON line per series (NaN → null); ``extra`` prepends a
        metadata line tagged ``"meta"`` so consumers can key the snapshot."""
        path = pathlib.Path(path)
        lines = []
        if extra is not None:
            lines.append(json.dumps(
                sanitize_json({"type": "meta", **extra}), allow_nan=False))
        for row in self.snapshot():
            lines.append(json.dumps(sanitize_json(row), allow_nan=False))
        path.write_text("\n".join(lines) + "\n")
        return path


# The process-default registry: trainer/scheduler/kernels report here unless
# handed an explicit registry (tests pass their own for isolation).
REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return REGISTRY
