"""Typed, thread-safe metric registry: Counter / Gauge / Histogram (the JAX
package's ``metrics/registry.py``, whole).

In-process instruments the data plane records into: per-op latency
histograms, byte counters, live gauges, rendered as Prometheus text
(:func:`render_prometheus`) or dumped as JSON (:meth:`MetricRegistry.snapshot`).

Semantics follow the Prometheus client model:

- instruments are created through a :class:`MetricRegistry` (get-or-create by
  name; re-creating with a different kind raises);
- optional label sets: ``counter.labels(op="read").inc()``; each distinct
  label-value tuple is an independent series;
- :class:`Histogram` uses fixed exponential bucket boundaries (no dynamic
  resizing, so merging and rendering are trivial and lock holds O(1)).

Off by default, and then free: every mutator checks the module-level flag
first and returns at once, and the hot paths guard whole blocks with
:func:`enabled`. Turn it on with :func:`enable` or the ``S3SHUFFLE_METRICS``
environment variable (any non-empty value). The port's straggler
speculation reads its threshold from the fill histograms here, so it never
races while the registry is off (``coding/degraded.py``).
"""

from __future__ import annotations

import os
import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

_enabled = False


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def exponential_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` upper bounds ``start * factor**i`` (the +Inf bucket is
    implicit — every histogram series carries one extra overflow bin)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor**i for i in range(count))


#: latency buckets: 100 µs .. ~52 s (object-store ops span 4+ decades)
DEFAULT_TIME_BUCKETS = exponential_buckets(1e-4, 2.0, 20)
#: size buckets: 256 B .. 1 GiB
DEFAULT_BYTES_BUCKETS = exponential_buckets(256.0, 4.0, 12)


def quantile_from_buckets(
    bounds: Sequence[float], counts: Sequence[int], q: float
) -> float:
    """Estimate the q-quantile from per-bin counts (``counts`` has one more
    entry than ``bounds`` — the +Inf overflow bin). Linear interpolation
    within the winning bin; overflow answers the last finite bound (a lower
    bound on the true value). The single home of the bucket math."""
    total = sum(counts)
    if total == 0:
        return 0.0
    target = q * total
    cum = 0.0
    for i, n in enumerate(counts):
        if n == 0:
            continue
        if cum + n >= target:
            if i >= len(bounds):  # overflow bin
                return float(bounds[-1])
            lo = float(bounds[i - 1]) if i > 0 else 0.0
            hi = float(bounds[i])
            frac = (target - cum) / n
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
        cum += n
    return float(bounds[-1]) if bounds else 0.0


class HistogramSnapshot:
    """Immutable point-in-time histogram read for the closed-loop tuners.

    Produced by :meth:`Histogram.read` WITHOUT touching the per-series
    writer locks (see there), so a controller polling between decisions can
    never stall a hot-path ``observe``."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(
        self, bounds: Sequence[float], counts: Sequence[int], sum_: float, count: int
    ):
        self.bounds = tuple(bounds)
        self.counts = tuple(counts)
        self.sum = float(sum_)
        self.count = int(count)

    def percentile(self, q: float) -> float:
        return quantile_from_buckets(self.bounds, self.counts, q)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def delta(self, prev: "HistogramSnapshot") -> "HistogramSnapshot":
        """Interval view since ``prev`` (same instrument, earlier read)."""
        if prev.bounds != self.bounds or not prev.counts:
            return self
        return HistogramSnapshot(
            self.bounds,
            [max(0, a - b) for a, b in zip(self.counts, prev.counts)],
            max(0.0, self.sum - prev.sum),
            max(0, self.count - prev.count),
        )

    @classmethod
    def empty(cls) -> "HistogramSnapshot":
        return cls((), (), 0.0, 0)


class _Metric:
    """Shared series bookkeeping; subclasses define the per-series state."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if tuple(sorted(labels)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"metric {self.name} expects labels {self.labelnames}, "
                f"got {tuple(labels)}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def labels(self, **labels: str):
        """Bound child for one label-value combination (cached)."""
        key = self._key(labels)
        with self._lock:
            child = self._series.get(key)
            if child is None:
                child = self._new_series()
                self._series[key] = child
        return child

    def _default(self):
        """The unlabeled series (only legal when labelnames is empty)."""
        return self.labels()

    def _new_series(self):
        raise NotImplementedError

    def clear(self) -> None:
        """Drop recorded series (the instrument itself stays registered)."""
        with self._lock:
            self._series.clear()

    def snapshot(self) -> dict:
        with self._lock:
            series = [
                {
                    **({"labels": dict(zip(self.labelnames, key))} if key else {}),
                    **child.dump(),  # type: ignore[attr-defined]
                }
                for key, child in self._series.items()
            ]
        out = {"kind": self.kind, "series": series}
        if self.help:
            out["help"] = self.help
        if self.labelnames:
            out["labelnames"] = list(self.labelnames)
        return out


class _CounterSeries:
    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self.value += value

    def dump(self) -> dict:
        return {"value": self.value}


class Counter(_Metric):
    kind = "counter"

    def _new_series(self) -> _CounterSeries:
        return _CounterSeries()

    def inc(self, value: float = 1.0) -> None:
        if not _enabled:
            return
        self._default().inc(value)


class _GaugeSeries:
    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        if not _enabled:
            return
        self.value = float(value)  # atomic swap; no lock needed to set

    def inc(self, value: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self.value += value

    def dec(self, value: float = 1.0) -> None:
        self.inc(-value)

    def dump(self) -> dict:
        return {"value": self.value}


class Gauge(_Metric):
    kind = "gauge"

    def _new_series(self) -> _GaugeSeries:
        return _GaugeSeries()

    def set(self, value: float) -> None:
        if not _enabled:
            return
        self._default().set(value)

    def inc(self, value: float = 1.0) -> None:
        if not _enabled:
            return
        self._default().inc(value)

    def dec(self, value: float = 1.0) -> None:
        self.inc(-value)


class _HistogramSeries:
    __slots__ = ("bounds", "counts", "sum", "count", "_lock")

    def __init__(self, bounds: Tuple[float, ...]):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last bin = +Inf overflow
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        if not _enabled:
            return
        i = bisect_left(self.bounds, value)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1

    def dump(self) -> dict:
        with self._lock:
            return {
                "le": list(self.bounds),  # per-bin counts, NOT cumulative
                "buckets": list(self.counts),
                "sum": self.sum,
                "count": self.count,
            }

    def read(self) -> HistogramSnapshot:
        """Lock-light read for the tuning controllers: list-element loads
        are GIL-atomic, so this never touches the writer lock ``observe``
        takes. The price is a torn view at most one in-flight observation
        wide (count/sum may disagree by one sample), which interval-delta
        consumers tolerate by construction."""
        return HistogramSnapshot(self.bounds, tuple(self.counts), self.sum, self.count)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ):
        super().__init__(name, help, labelnames)
        bounds = tuple(buckets if buckets is not None else DEFAULT_TIME_BUCKETS)
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError("histogram buckets must be strictly increasing")
        self.buckets = bounds

    def _new_series(self) -> _HistogramSeries:
        return _HistogramSeries(self.buckets)

    def observe(self, value: float) -> None:
        if not _enabled:
            return
        self._default().observe(value)

    def read(self) -> HistogramSnapshot:
        """Lock-light merged snapshot across every label series — the tuning
        controllers' read API. Only the series-table lock (taken by series
        CREATION, not by ``observe``) is held, and only to copy the dict;
        the per-series writer locks are never touched."""
        with self._lock:
            children = list(self._series.values())
        counts: Optional[list] = None
        total_sum, total_count = 0.0, 0
        for child in children:
            snap = child.read()  # type: ignore[attr-defined]
            total_sum += snap.sum
            total_count += snap.count
            if counts is None:
                counts = list(snap.counts)
            else:
                counts = [a + b for a, b in zip(counts, snap.counts)]
        if counts is None:
            return HistogramSnapshot(self.buckets, (0,) * (len(self.buckets) + 1), 0.0, 0)
        return HistogramSnapshot(self.buckets, counts, total_sum, total_count)

    def percentile(self, q: float) -> float:
        """Convenience quantile over the merged series."""
        return self.read().percentile(q)


class MetricRegistry:
    """Get-or-create instrument registry; the process default is
    :data:`REGISTRY`. All methods are thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, labelnames, **kwargs):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is not None:
                if not isinstance(metric, cls) or (
                    labelnames and tuple(labelnames) != metric.labelnames
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{metric.kind} with labels {metric.labelnames}"
                    )
                return metric
            metric = cls(name, help, labelnames, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self, compact: bool = False) -> dict:
        """JSON-able dump of every metric. ``compact`` drops series that
        never recorded anything (and metrics left with no series) — the shape
        BENCH artifacts and ShuffleStats reports embed."""
        out = {}
        for metric in self.metrics():
            snap = metric.snapshot()
            if compact:
                snap["series"] = [
                    s for s in snap["series"]
                    if s.get("count", 0) or s.get("value", 0)
                ]
                if not snap["series"]:
                    continue
            out[metric.name] = snap
        return out

    def reset(self) -> None:
        """Drop every registered metric (tests)."""
        with self._lock:
            self._metrics.clear()

    def reset_values(self) -> None:
        """Zero every metric's recorded series while keeping the instruments
        registered — module-level instrument handles (the data plane holds
        them) stay valid, unlike :meth:`reset`."""
        for metric in self.metrics():
            metric.clear()


#: process-default registry — the data plane's instruments all live here
REGISTRY = MetricRegistry()


def read_counter_total(name: str, registry: MetricRegistry = REGISTRY) -> float:
    """Lock-light sum of a counter's series values (0.0 when the instrument
    does not exist) — the tuners' counter-signal read. Per-series value loads
    are GIL-atomic; the writer lock ``inc`` takes is never touched."""
    metric = registry.get(name)
    if metric is None:
        return 0.0
    with metric._lock:
        children = list(metric._series.values())
    return sum(float(getattr(c, "value", 0.0)) for c in children)


def read_histogram(name: str, registry: MetricRegistry = REGISTRY) -> HistogramSnapshot:
    """Lock-light merged :class:`HistogramSnapshot` of a histogram (empty
    snapshot when the instrument does not exist or is another kind)."""
    metric = registry.get(name)
    if not isinstance(metric, Histogram):
        return HistogramSnapshot.empty()
    return metric.read()


def _escape_label(value: str) -> str:
    return (
        str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt(value: float) -> str:
    return repr(int(value)) if float(value).is_integer() else repr(float(value))


def render_prometheus(
    registry: MetricRegistry = REGISTRY,
    extra_labels: Optional[Dict[str, str]] = None,
    prefix: str = "s3shuffle_",
) -> str:
    """Prometheus exposition text for every series in ``registry``:
    counters/gauges as single samples, histograms as the conventional
    ``_bucket`` (cumulative, with ``le``) / ``_sum`` / ``_count`` triplet."""
    base = {k: _escape_label(v) for k, v in (extra_labels or {}).items()}
    lines: List[str] = []

    def label_str(series: dict, extra: Optional[Dict[str, str]] = None) -> str:
        labels = dict(base)
        labels.update(
            {k: _escape_label(v) for k, v in series.get("labels", {}).items()}
        )
        if extra:
            labels.update(extra)
        if not labels:
            return ""
        return "{" + ",".join(f'{k}="{v}"' for k, v in labels.items()) + "}"

    for metric in registry.metrics():
        snap = metric.snapshot()
        name = prefix + "".join(
            c if c.isalnum() or c == "_" else "_" for c in metric.name
        )
        if not snap["series"]:
            continue
        lines.append(f"# TYPE {name} {metric.kind}")
        if metric.help:
            lines.append(f"# HELP {name} {metric.help}")
        for series in snap["series"]:
            if metric.kind == "histogram":
                cum = 0
                for bound, n in zip(series["le"], series["buckets"]):
                    cum += n
                    lines.append(
                        f'{name}_bucket{label_str(series, {"le": _fmt(bound)})} {cum}'
                    )
                cum += series["buckets"][-1]
                lines.append(
                    f'{name}_bucket{label_str(series, {"le": "+Inf"})} {cum}'
                )
                lines.append(f"{name}_sum{label_str(series)} {_fmt(series['sum'])}")
                lines.append(f"{name}_count{label_str(series)} {series['count']}")
            else:
                lines.append(f"{name}{label_str(series)} {_fmt(series['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def _maybe_enable_from_env() -> None:
    if os.environ.get("S3SHUFFLE_METRICS"):
        enable()


_maybe_enable_from_env()
