"""Unified metrics: Counter / Gauge / Histogram + per-process registry.

The port's copy of ``aiko_services_tpu/obs/metrics.py`` (it has no JAX
in it); its imports point at the port's own modules.

Replaces the hand-rolled counter dicts and nearest-rank percentile
lists scattered through ``orchestration/``, ``tools/loadgen.py`` and
``kvstore/`` with one model:

* **Counter** — monotonically increasing float.
* **Gauge** — last-set value (used to mirror the legacy ``counters``
  dicts verbatim, which tests and telemetry still read directly).
* **Histogram** — fixed LOG-SPACED buckets shared by construction
  (:data:`DEFAULT_BOUNDS`), so two histograms from different replicas
  merge EXACTLY (element-wise bucket add) and fleet-level quantiles at
  the router/dashboard/loadgen are well-defined — unlike nearest-rank
  over one replica's window.  Quantile estimates are bounded by bucket
  width (~58% per step at 8 buckets/decade; the merge property test
  pins this).

Encoding: a histogram serializes to a compact sparse string
(``"h1:<count>:<sum>:i=c,i=c,…"``) that rides EC shares like the
kvstore prefix digests do, and parses back without ambiguity because
the bounds are a process-wide constant.  Prometheus text exposition is
:meth:`MetricsRegistry.to_prometheus` — wired to the ``(metrics …)``
actor command so ANY running service can be scraped over the wire.

Stdlib-only on purpose (see the ``obs`` package docstring).
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "CounterDict", "DEFAULT_BOUNDS", "REGISTRY"]

#: Fixed log-spaced bucket upper bounds, 8 per decade from 0.01 to 1e5
#: (units are whatever the caller observes — milliseconds everywhere in
#: this repo).  Fixed-by-construction is the whole point: every
#: histogram in every process has IDENTICAL bounds, so merge is
#: element-wise and cross-replica quantiles are exact up to bucket
#: width (10^(1/8) ≈ 1.33× per bucket).
DEFAULT_BOUNDS: Tuple[float, ...] = tuple(
    round(10.0 ** (exponent / 8.0), 6) for exponent in range(-16, 41))

_ENCODING_VERSION = "h1"


class Counter:
    """Monotonic counter.  ``inc`` only; negative increments raise."""

    __slots__ = ("name", "help", "labels", "value")

    def __init__(self, name: str, help: str = "",  # noqa: A002
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc")
        self.value += amount


class Gauge:
    """Last-written value (can move both ways)."""

    __slots__ = ("name", "help", "labels", "value")

    def __init__(self, name: str, help: str = "",  # noqa: A002
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.value = 0.0

    def set(self, value: float):
        self.value = float(value)

    def inc(self, amount: float = 1.0):
        self.value += amount


class Histogram:
    """Fixed-bucket histogram; all instances share the same bounds.

    ``counts`` has ``len(bounds) + 1`` slots — the last is the
    overflow bucket.  ``observe`` is a bisect + two adds (cheap enough
    for per-request call sites; per-STEP events go through
    :mod:`.steplog` instead).
    """

    __slots__ = ("name", "help", "labels", "bounds", "counts",
                 "count", "sum")

    def __init__(self, name: str = "", help: str = "",  # noqa: A002
                 labels: Optional[Dict[str, str]] = None,
                 bounds: Tuple[float, ...] = DEFAULT_BOUNDS):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float):
        value = float(value)
        if math.isnan(value):
            return
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.count += 1
        self.sum += value

    def merge(self, other: "Histogram") -> "Histogram":
        """Element-wise merge IN PLACE (bounds must match — they always
        do unless someone bypassed DEFAULT_BOUNDS).  Returns self."""
        if other.bounds != self.bounds:
            raise ValueError("histogram bounds mismatch: cannot merge")
        for index, count in enumerate(other.counts):
            self.counts[index] += count
        self.count += other.count
        self.sum += other.sum
        return self

    @classmethod
    def merged(cls, histograms: Iterable["Histogram"],
               name: str = "") -> "Histogram":
        result = cls(name=name)
        for histogram in histograms:
            result.merge(histogram)
        return result

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile: the GEOMETRIC midpoint of the
        bucket holding the q-th sample (log-spaced buckets make the
        geometric mean the unbiased representative).  0.0 when empty;
        the last finite bound for overflow samples."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        cumulative = 0
        for index, count in enumerate(self.counts):
            cumulative += count
            if cumulative >= rank:
                if index >= len(self.bounds):         # overflow bucket
                    return self.bounds[-1]
                upper = self.bounds[index]
                lower = self.bounds[index - 1] if index else upper / 10.0
                return math.sqrt(lower * upper)
        return self.bounds[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    # -- wire ---------------------------------------------------------------- #

    def encode(self) -> str:
        """Sparse string for EC shares: ``h1:<count>:<sum>:i=c,…``."""
        sparse = ",".join(f"{index}={count}"
                          for index, count in enumerate(self.counts)
                          if count)
        return f"{_ENCODING_VERSION}:{self.count}:{self.sum:.6g}:{sparse}"

    @classmethod
    def decode(cls, text: str, name: str = "") -> "Histogram":
        version, count, total, sparse = str(text).split(":", 3)
        if version != _ENCODING_VERSION:
            raise ValueError(f"unknown histogram encoding: {version!r}")
        histogram = cls(name=name)
        histogram.count = int(count)
        histogram.sum = float(total)
        if sparse:
            for item in sparse.split(","):
                index, _, bucket_count = item.partition("=")
                histogram.counts[int(index)] = int(bucket_count)
        return histogram


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple:
    return tuple(sorted((labels or {}).items()))


def _format_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(f'{key}="{value}"'
                    for key, value in sorted(labels.items()))
    return "{" + body + "}"


class MetricsRegistry:
    """Per-process metric store: (name, labels) → metric instance.

    ``counter``/``gauge``/``histogram`` are get-or-create so call sites
    never coordinate; creation takes a lock, updates rely on the GIL
    (single float add — the same bet the legacy counter dicts made).
    """

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple], object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str,  # noqa: A002
                       labels: Optional[Dict[str, str]]):
        key = (name, _label_key(labels))
        metric = self._metrics.get(key)
        if metric is None:
            with self._lock:
                metric = self._metrics.get(key)
                if metric is None:
                    metric = cls(name, help=help, labels=labels)
                    self._metrics[key] = metric
        if not isinstance(metric, cls):
            raise TypeError(f"metric {name} already registered as "
                            f"{type(metric).__name__}")
        return metric

    def counter(self, name: str, help: str = "",  # noqa: A002
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",  # noqa: A002
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",  # noqa: A002
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels)

    def collect(self) -> List[object]:
        return list(self._metrics.values())

    def snapshot(self) -> Dict[str, object]:
        """Flat name{labels} → value (histograms: count/sum/p50/p95/p99)."""
        out: Dict[str, object] = {}
        for metric in self.collect():
            key = f"{metric.name}{_format_labels(metric.labels)}"
            if isinstance(metric, Histogram):
                out[key] = {"count": metric.count, "sum": metric.sum,
                            "p50": metric.quantile(0.50),
                            "p95": metric.quantile(0.95),
                            "p99": metric.quantile(0.99)}
            else:
                out[key] = metric.value
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: List[str] = []
        seen_types = set()
        for metric in sorted(self.collect(), key=lambda m: m.name):
            if isinstance(metric, Histogram):
                if metric.name not in seen_types:
                    seen_types.add(metric.name)
                    if metric.help:
                        lines.append(f"# HELP {metric.name} {metric.help}")
                    lines.append(f"# TYPE {metric.name} histogram")
                cumulative = 0
                for index, bound in enumerate(metric.bounds):
                    cumulative += metric.counts[index]
                    labels = dict(metric.labels, le=f"{bound:g}")
                    lines.append(f"{metric.name}_bucket"
                                 f"{_format_labels(labels)} {cumulative}")
                labels = dict(metric.labels, le="+Inf")
                lines.append(f"{metric.name}_bucket"
                             f"{_format_labels(labels)} {metric.count}")
                tags = _format_labels(metric.labels)
                lines.append(f"{metric.name}_sum{tags} {metric.sum:g}")
                lines.append(f"{metric.name}_count{tags} {metric.count}")
            else:
                kind = ("counter" if isinstance(metric, Counter)
                        else "gauge")
                if metric.name not in seen_types:
                    seen_types.add(metric.name)
                    if metric.help:
                        lines.append(f"# HELP {metric.name} {metric.help}")
                    lines.append(f"# TYPE {metric.name} {kind}")
                lines.append(f"{metric.name}"
                             f"{_format_labels(metric.labels)} "
                             f"{metric.value:g}")
        return "\n".join(lines) + ("\n" if lines else "")


#: Process-wide default registry — always on (a metric update is one
#: float add; only TRACING and the step recorder need the nullable
#: zero-cost guard).
REGISTRY = MetricsRegistry()


class CounterDict(dict):
    """A drop-in for the legacy ``self.counters`` dicts that mirrors
    every write into registry gauges, so ``counters["shed"] += 1``
    keeps working for tests/telemetry while ``(metrics …)`` and the
    dashboard see the same numbers under unified names
    (``aiko_<prefix>_<key>``)."""

    def __init__(self, initial: Dict, prefix: str,
                 labels: Optional[Dict[str, str]] = None,
                 registry: Optional[MetricsRegistry] = None):
        super().__init__()
        self._registry = registry or REGISTRY
        self._prefix = prefix
        self._labels = dict(labels or {})
        for key, value in dict(initial).items():
            self[key] = value

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        if isinstance(value, (int, float)) and \
                not isinstance(value, bool):
            self._registry.gauge(f"aiko_{self._prefix}_{key}",
                                 labels=self._labels).set(value)
