"""Fixed-bucket latency histogram — a copy of ``Histogram`` and its
``DEFAULT_BUCKETS`` from ``tensorhive_tpu/observability/metrics.py``, on a
plain ``threading.Lock`` where JAX uses its lock witness.

Prometheus-style cumulative buckets chosen at construction; observation
is O(log buckets) via bisect, and the quantile estimator interpolates
linearly inside the bucket (PromQL's ``histogram_quantile`` model), so a
p50/p95 needs no stored samples. The metric families, the registry and
the text exposition are not ported yet.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import List, Optional, Sequence, Tuple

#: default latency buckets (seconds): 1 ms .. 60 s, roughly log-spaced
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Histogram:
    """Fixed-bucket cumulative histogram. Each engine keeps private ones
    (TTFT, inter-token gap, queue wait), so instances never share counts."""

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count", "_max")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError("bucket bounds must be strictly increasing")
        self._lock = threading.Lock()
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
