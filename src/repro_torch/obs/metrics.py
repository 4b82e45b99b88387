"""Label-keyed metrics registry: counters, gauges, histograms, series.

``TeleRAGServer``'s telemetry dataclasses are *views* over this
registry: the server's lifetime counts (completed / waves / batches)
and every per-tenant SLO accumulator live here as first-class
instruments, keyed by ``(name, labels)`` — so the future autoscaler
and the telemetry snapshot read the same numbers.  Occupancy and
attainment are additionally sampled as ``TimeSeries`` (time-stamped on
the shared event clock), which is what a control loop needs instead of
an end-of-run scalar.

Numerically this is a refactor, not a change: ``Histogram.percentile``
is ``np.percentile`` over the raw samples, exactly what the pre-registry
``_TenantAcc`` computed — the snapshot values are pinned equal (1e-6)
by tests/test_obs.py and the existing tests/test_slo.py assertions.

This module is a copy of the JAX package's module of the same path,
imports repointed.  The tests its comments name pin the JAX package's
copy; ``tests/test_torch_api.py`` holds this one to it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

import numpy as np

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


@dataclass
class Counter:
    """Monotone accumulator (float so second-valued sums fit too)."""

    name: str
    labels: LabelKey = ()
    value: float = 0.0

    def inc(self, n: float = 1.0) -> float:
        self.value += n
        return self.value


@dataclass
class Gauge:
    """Last-write-wins scalar."""

    name: str
    labels: LabelKey = ()
    value: float = 0.0

    def set(self, v: float) -> float:
        self.value = float(v)
        return self.value


@dataclass
class Histogram:
    """Raw-sample histogram: keeps every observation so percentiles are
    exact (``np.percentile``), matching the pre-registry accumulators
    bit-for-bit at serving scales."""

    name: str
    labels: LabelKey = ()
    samples: List[float] = field(default_factory=list)

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self) -> float:
        return float(np.sum(self.samples)) if self.samples else 0.0

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.samples else 0.0

    def percentile(self, q: float) -> float:
        """``np.percentile`` over the raw samples (0 when empty)."""
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples), q))


@dataclass
class TimeSeries:
    """(t, value) samples on the shared event clock — the consumable
    form of occupancy/attainment for control loops."""

    name: str
    labels: LabelKey = ()
    samples: List[Tuple[float, float]] = field(default_factory=list)

    def sample(self, t: float, v: float) -> None:
        self.samples.append((float(t), float(v)))

    def sorted_samples(self) -> List[Tuple[float, float]]:
        """Samples in event-clock order (emission can be post-hoc)."""
        return sorted(self.samples)

    @property
    def last(self) -> float:
        """Most recent value on the clock (0 when never sampled)."""
        s = self.sorted_samples()
        return s[-1][1] if s else 0.0


class MetricsRegistry:
    """Get-or-create instrument store keyed by ``(name, labels)``."""

    def __init__(self) -> None:
        self._counters: Dict[Tuple[str, LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelKey], Gauge] = {}
        self._histograms: Dict[Tuple[str, LabelKey], Histogram] = {}
        self._series: Dict[Tuple[str, LabelKey], TimeSeries] = {}

    def counter(self, name: str, **labels: object) -> Counter:
        key = (name, _label_key(labels))
        if key not in self._counters:
            self._counters[key] = Counter(name, key[1])
        return self._counters[key]

    def gauge(self, name: str, **labels: object) -> Gauge:
        key = (name, _label_key(labels))
        if key not in self._gauges:
            self._gauges[key] = Gauge(name, key[1])
        return self._gauges[key]

    def histogram(self, name: str, **labels: object) -> Histogram:
        key = (name, _label_key(labels))
        if key not in self._histograms:
            self._histograms[key] = Histogram(name, key[1])
        return self._histograms[key]

    def series(self, name: str, **labels: object) -> TimeSeries:
        key = (name, _label_key(labels))
        if key not in self._series:
            self._series[key] = TimeSeries(name, key[1])
        return self._series[key]

    def label_values(self, name: str, label: str) -> List[str]:
        """Distinct values one label takes across all instruments of
        ``name`` (e.g. every tenant a histogram was observed for)."""
        out = []
        for store in (self._counters, self._gauges,
                      self._histograms, self._series):
            for (n, lk) in store:
                for k, v in lk:
                    if n == name and k == label and v not in out:
                        out.append(v)
        return sorted(out)

    def collect(self) -> List[Dict[str, object]]:
        """Flat dump of every instrument (export / debugging)."""
        rows: List[Dict[str, object]] = []
        for (name, lk), c in self._counters.items():
            rows.append({"type": "counter", "name": name,
                         "labels": dict(lk), "value": c.value})
        for (name, lk), g in self._gauges.items():
            rows.append({"type": "gauge", "name": name,
                         "labels": dict(lk), "value": g.value})
        for (name, lk), h in self._histograms.items():
            rows.append({"type": "histogram", "name": name,
                         "labels": dict(lk), "count": h.count,
                         "sum": h.sum,
                         "p50": h.percentile(50), "p99": h.percentile(99)})
        for (name, lk), s in self._series.items():
            rows.append({"type": "series", "name": name,
                         "labels": dict(lk), "samples": len(s.samples),
                         "last": s.last})
        return rows

    def items(self) -> Iterable[Tuple[str, object]]:
        """Every (name, instrument) pair across the four stores."""
        for store in (self._counters, self._gauges,
                      self._histograms, self._series):
            for (name, _lk), inst in store.items():
                yield name, inst
