"""Service base class — the counterpart of
``tensorhive_tpu/core/services/base.py``: a periodic daemon thread,
``do_run()`` every ``interval_s`` seconds, with uniform tick timing. Each
tick lands in the ``tpuhive_service_tick_seconds`` histogram of the port's
registry, overruns in a counter, and each tick records a span. The JAX
class also takes the control plane's shared managers (``inject``); the
port runs no control plane, so that hook is not copied.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Optional

from ...observability import Histogram, get_registry, get_tracer
from ...utils.threading import StoppableThread

log = logging.getLogger(__name__)

# registered once at import; every Service instance feeds the child for its
# own service label
_TICK_SECONDS = get_registry().histogram(
    "tpuhive_service_tick_seconds",
    "Duration of one service do_run() tick.", labels=("service",))
_TICKS_TOTAL = get_registry().counter(
    "tpuhive_service_ticks_total",
    "Completed service ticks (including failed ones).", labels=("service",))
_TICK_FAILURES = get_registry().counter(
    "tpuhive_service_tick_failures_total",
    "Service ticks that raised an exception.", labels=("service",))
_TICK_OVERRUNS = get_registry().counter(
    "tpuhive_service_tick_overruns_total",
    "Ticks that ran longer than the service interval (interval starvation).",
    labels=("service",))


class Service(StoppableThread):
    """Periodic daemon thread: ``do_run()`` every ``interval_s`` seconds.

    Subclasses implement :meth:`do_run`; the run loop measures each tick,
    records it into the registry and the span tracer, and sleeps out the
    rest of the interval (interruptible by shutdown)."""

    def __init__(self, interval_s: float, name: Optional[str] = None) -> None:
        super().__init__(name=name or type(self).__name__)
        self.interval_s = interval_s
        #: per-instance latency histogram behind the p50/p95/max
        #: introspection (the registry child is shared per label)
        self._tick_hist = Histogram()
        self.ticks_completed = 0
        self.tick_overruns = 0
        self._overrun_warned = False
        #: wall-clock stamps of the last completed tick and the run-loop
        #: entry
        self.last_tick_ts: Optional[float] = None
        self.run_started_ts: Optional[float] = None

    # -- loop ---------------------------------------------------------------
    def run(self) -> None:
        tracer = get_tracer()
        self.run_started_ts = time.time()
        while not self.stopped:
            started = time.perf_counter()
            span = tracer.start_span(f"tick.{self.name}", kind="tick",
                                     service=self.name)
            status = "ok"
            try:
                self.do_run()
            except Exception:
                # a crashing tick must not kill the daemon thread
                log.exception("%s tick failed", self.name)
                _TICK_FAILURES.labels(service=self.name).inc()
                status = "error"
            elapsed = time.perf_counter() - started
            tracer.end_span(span, status=status)
            self.record_tick(elapsed)
            remaining = self.interval_s - elapsed
            if remaining > 0:
                self.wait(remaining)
            else:
                self.record_overrun(elapsed)

    def record_tick(self, elapsed_s: float) -> None:
        """Account one tick (apart from run() so callers that tick by hand hit
        the same bookkeeping)."""
        self._tick_hist.observe(elapsed_s)
        _TICK_SECONDS.labels(service=self.name).observe(elapsed_s)
        _TICKS_TOTAL.labels(service=self.name).inc()
        self.ticks_completed += 1
        self.last_tick_ts = time.time()

    def record_overrun(self, elapsed_s: float) -> None:
        """A tick exceeded the interval. Counted always; the first overrun
        per service is a warning, later ones log at debug."""
        self.tick_overruns += 1
        _TICK_OVERRUNS.labels(service=self.name).inc()
        if not self._overrun_warned:
            self._overrun_warned = True
            log.warning(
                "%s tick overran its interval: %.3fs > %.3fs — the service "
                "is running back-to-back; further overruns log at debug",
                self.name, elapsed_s, self.interval_s)
        else:
            log.debug("%s tick overran interval: %.3fs > %.3fs",
                      self.name, elapsed_s, self.interval_s)

    def do_run(self) -> None:
        raise NotImplementedError

    # -- introspection ------------------------------------------------------
    def tick_latency_stats(self) -> Dict[str, Optional[float]]:
        """{p50, p95, max} tick durations in seconds (None before the first
        tick); quantiles from the histogram buckets, max exact."""
        return {
            "p50": self._tick_hist.quantile(0.5),
            "p95": self._tick_hist.quantile(0.95),
            "max": self._tick_hist.max,
        }
