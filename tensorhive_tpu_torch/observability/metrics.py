"""In-process metrics of the port: counters, gauges, fixed-bucket
histograms and the Prometheus text exposition — a copy of
``tensorhive_tpu/observability/metrics.py`` on plain ``threading`` locks
where JAX uses its lock witness (a debugging aid of the JAX package).

* **Thread-safe under concurrent writers.** Each metric family serializes
  its own children behind one lock, so hot paths on different families
  never contend.
* **Idempotent registration.** ``registry.counter(name, ...)`` returns the
  existing family when the name is registered; re-registering with another
  type or label set raises.
* **Fixed bucket boundaries.** Histograms are Prometheus-style cumulative
  buckets chosen at registration; observation is O(log buckets) via
  bisect, and the quantile estimator interpolates linearly inside the
  bucket (PromQL's ``histogram_quantile`` model), so a p50/p95 needs no
  stored samples. The serving engine keeps private ``Histogram`` instances
  for its ``stats()`` quantiles and Retry-After estimates.

Exposition follows the Prometheus text format (0.0.4): HELP/TYPE headers,
``_bucket``/``_sum``/``_count`` for histograms, label escaping; families
render sorted by name and children by label values, and the family names
are the JAX package's (``tpuhive_*``), so a scrape of either package reads
the same.
"""
from __future__ import annotations

import logging
import math
import os
import threading
import time
from bisect import bisect_left
from typing import (
    Callable,
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

log = logging.getLogger(__name__)

#: wall-clock import time of this module, about the process start — backs
#: the process uptime gauge
PROCESS_START_TS = time.time()

#: default latency buckets (seconds): 1 ms .. 60 s, roughly log-spaced
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _format_value(value: float) -> str:
    """Render a sample value: integral floats collapse to integers, non-finite
    values use Prometheus spelling."""
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if math.isnan(value):
        return "NaN"
    as_float = float(value)
    if as_float.is_integer() and abs(as_float) < 1e15:
        return str(int(as_float))
    return repr(as_float)


def _escape_label_value(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _escape_help(value: str) -> str:
    return value.replace("\\", r"\\").replace("\n", r"\n")


def _render_labels(names: Sequence[str], values: Sequence[str],
                   extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [f'{name}="{_escape_label_value(value)}"'
             for name, value in zip(names, values)]
    if extra is not None:
        pairs.append(f'{extra[0]}="{_escape_label_value(extra[1])}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


class Counter:
    """Monotonically increasing value (one child of a counter family)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock) -> None:
        self._lock = lock
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        self._value = 0.0


class Gauge:
    """Value that can go up and down (one child of a gauge family)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock) -> None:
        self._lock = lock
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        self._value = 0.0


class Histogram:
    """Fixed-bucket cumulative histogram: one child of a histogram family
    (sharing the family's lock), or standalone (``Histogram()``), as each
    engine keeps private ones (TTFT, inter-token gap, queue wait), so
    instances never share counts."""

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count", "_max")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS,
                 lock: Optional[threading.Lock] = None) -> None:
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError("bucket bounds must be strictly increasing")
        self._lock = lock or threading.Lock()
        self.buckets = bounds
        self._counts = [0] * (len(bounds) + 1)   # +1 for the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._max: Optional[float] = None

    def observe(self, value: float) -> None:
        value = float(value)
        index = bisect_left(self.buckets, value)
        with self._lock:
            self._counts[index] += 1
            self._sum += value
            self._count += 1
            if self._max is None or value > self._max:
                self._max = value

    def snapshot(self) -> Tuple[List[int], float, int, Optional[float]]:
        """(per-bucket counts incl. +Inf, sum, count, max) — consistent."""
        with self._lock:
            return list(self._counts), self._sum, self._count, self._max

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def max(self) -> Optional[float]:
        with self._lock:
            return self._max

    def _reset(self) -> None:
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._max = None

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the q-quantile (0..1) from bucket counts by linear
        interpolation inside the bucket. None with no observations. The
        estimate is clamped to the observed max, so a +Inf-bucket hit
        cannot report an unbounded latency."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be within [0, 1]")
        counts, _, total, observed_max = self.snapshot()
        if total == 0:
            return None
        rank = q * total
        cumulative = 0.0
        for index, bucket_count in enumerate(counts):
            if bucket_count == 0:
                continue
            if cumulative + bucket_count >= rank:
                fraction = (rank - cumulative) / bucket_count
                lower = 0.0 if index == 0 else self.buckets[index - 1]
                if index < len(self.buckets):
                    estimate = lower + (self.buckets[index] - lower) * fraction
                else:               # +Inf bucket: no upper bound to lerp to
                    estimate = (observed_max if observed_max is not None
                                else lower)
                if observed_max is not None:
                    estimate = min(estimate, observed_max)
                return estimate
            cumulative += bucket_count
        return observed_max


_KINDS = ("counter", "gauge", "histogram")


class MetricFamily:
    """A named metric plus its labeled children."""

    def __init__(self, kind: str, name: str, help_text: str,
                 label_names: Sequence[str],
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.kind = kind
        self.name = name
        self.help_text = help_text
        self.label_names = tuple(label_names)
        self.bucket_bounds = tuple(buckets)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, **labels: str):
        """Child for one label-value combination (created on first use)."""
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name} expects labels {self.label_names}, got "
                f"{tuple(sorted(labels))}")
        key = tuple(str(labels[name]) for name in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def _make_child(self):
        # children share the family lock: one uncontended lock per family
        if self.kind == "counter":
            return Counter(self._lock)
        if self.kind == "gauge":
            return Gauge(self._lock)
        return Histogram(self.bucket_bounds, lock=self._lock)

    def _unlabeled(self):
        """The single child of a label-less family."""
        if self.label_names:
            raise ValueError(f"{self.name} requires labels {self.label_names}")
        return self.labels()

    # label-less convenience: family.inc() / family.set() / family.observe()
    def inc(self, amount: float = 1.0) -> None:
        self._unlabeled().inc(amount)

    def set(self, value: float) -> None:
        self._unlabeled().set(value)

    def dec(self, amount: float = 1.0) -> None:
        self._unlabeled().dec(amount)

    def observe(self, value: float) -> None:
        self._unlabeled().observe(value)

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    def reset_values(self) -> None:
        """Zero every child's value IN PLACE: instrumented modules hold
        child references captured at import."""
        with self._lock:
            for child in self._children.values():
                child._reset()

    def retain_children(self, keys: Iterable[Tuple[str, ...]]) -> None:
        """Drop every child whose label tuple is not in ``keys`` — the
        cardinality bound of families whose sole writer is a render-time
        collector (the ``tpuhive_tenant_*`` exports)."""
        keep = set(keys)
        with self._lock:
            for key in list(self._children):
                if key not in keep:
                    del self._children[key]


class MetricsRegistry:
    """Thread-safe collection of metric families + Prometheus rendering."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []

    # -- registration (idempotent) ------------------------------------------
    def _register(self, kind: str, name: str, help_text: str,
                  label_names: Sequence[str],
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> MetricFamily:
        with self._lock:
            existing = self._families.get(name)
            if existing is not None:
                if (existing.kind != kind
                        or existing.label_names != tuple(label_names)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.label_names}")
                return existing
            family = MetricFamily(kind, name, help_text, label_names, buckets)
            self._families[name] = family
            return family

    def counter(self, name: str, help_text: str = "",
                labels: Sequence[str] = ()) -> MetricFamily:
        return self._register("counter", name, help_text, labels)

    def gauge(self, name: str, help_text: str = "",
              labels: Sequence[str] = ()) -> MetricFamily:
        return self._register("gauge", name, help_text, labels)

    def histogram(self, name: str, help_text: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> MetricFamily:
        return self._register("histogram", name, help_text, labels, buckets)

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[MetricFamily]:
        with self._lock:
            return [self._families[name] for name in sorted(self._families)]

    def reset_values(self) -> None:
        """Zero every child's value but keep the families registered."""
        for family in self.families():
            family.reset_values()

    # -- lazy collectors ----------------------------------------------------
    def register_collector(
            self, collector: Callable[["MetricsRegistry"], None]) -> None:
        """Register a callback run at the start of every :meth:`render`, for
        values cheap to read but pointless to poll. Idempotent per
        callable."""
        with self._lock:
            if collector not in self._collectors:
                self._collectors.append(collector)

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for collector in collectors:
            try:
                collector(self)
            except Exception:
                # a broken collector must not take down the whole scrape
                log.exception("metrics collector %r failed", collector)

    # -- exposition ---------------------------------------------------------
    def render(self) -> str:
        """Prometheus text format 0.0.4; deterministic ordering."""
        self._run_collectors()
        lines: List[str] = []
        for family in self.families():
            children = family.children()
            if not children:
                continue
            if family.help_text:
                lines.append(f"# HELP {family.name} "
                             f"{_escape_help(family.help_text)}")
            lines.append(f"# TYPE {family.name} {family.kind}")
            for label_values, child in children:
                if family.kind == "histogram":
                    lines.extend(self._render_histogram(
                        family, label_values, child))
                else:
                    labels = _render_labels(family.label_names, label_values)
                    lines.append(
                        f"{family.name}{labels} {_format_value(child.value)}")
        return "\n".join(lines) + "\n" if lines else ""

    @staticmethod
    def _render_histogram(family: MetricFamily, label_values: Sequence[str],
                          child: Histogram) -> Iterable[str]:
        counts, total_sum, count, _ = child.snapshot()
        cumulative = 0
        for bound, bucket_count in zip(family.bucket_bounds, counts):
            cumulative += bucket_count
            labels = _render_labels(family.label_names, label_values,
                                    extra=("le", _format_value(bound)))
            yield f"{family.name}_bucket{labels} {cumulative}"
        labels = _render_labels(family.label_names, label_values,
                                extra=("le", "+Inf"))
        yield f"{family.name}_bucket{labels} {count}"
        plain = _render_labels(family.label_names, label_values)
        yield f"{family.name}_sum{plain} {_format_value(total_sum)}"
        yield f"{family.name}_count{plain} {count}"


# -- build info + process self-metrics ---------------------------------------

def _read_rss_bytes() -> Optional[float]:
    """Current resident set from /proc/self/status (None without a Linux
    procfs)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) * 1024.0
    except (OSError, ValueError, IndexError):
        return None
    return None


def _count_open_fds() -> Optional[float]:
    try:
        return float(len(os.listdir("/proc/self/fd")))
    except OSError:
        return None


def register_process_metrics(registry: MetricsRegistry,
                             version: str) -> None:
    """Register ``tpuhive_build_info{version}`` plus process self-metrics
    (RSS, thread count, uptime, open fds where /proc exists), refreshed by a
    collector at exposition time."""
    build_info = registry.gauge(
        "tpuhive_build_info",
        "Constant 1, labeled with the running tpuhive version.",
        labels=("version",))
    rss = registry.gauge(
        "tpuhive_process_resident_memory_bytes",
        "Resident set size of this process (from /proc/self/status).")
    threads = registry.gauge(
        "tpuhive_process_threads",
        "Live Python threads in this process.")
    uptime = registry.gauge(
        "tpuhive_process_uptime_seconds",
        "Seconds since the observability layer was imported.")
    open_fds = registry.gauge(
        "tpuhive_process_open_fds",
        "Open file descriptors (from /proc/self/fd; absent without procfs).")

    def _collect(_registry: MetricsRegistry) -> None:
        # set inside the collector so reset_values() cannot leave a stale
        # zero behind
        build_info.labels(version=version).set(1.0)
        rss_bytes = _read_rss_bytes()
        if rss_bytes is not None:
            rss.set(rss_bytes)
        threads.set(float(threading.active_count()))
        uptime.set(time.time() - PROCESS_START_TS)
        fds = _count_open_fds()
        if fds is not None:
            open_fds.set(fds)

    registry.register_collector(_collect)


def parse_rendered(text: str) -> Mapping[str, float]:
    """Parse exposition text back into {sample name + labels: value}."""
    samples: Dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, _, raw = line.rpartition(" ")
        samples[key] = float(raw)
    return samples
