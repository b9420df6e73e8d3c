"""Observability of the port — the counterpart of
``tensorhive_tpu/observability/`` for the serving plane:

* :mod:`.metrics` — a thread-safe in-process registry (counters, gauges,
  fixed-bucket histograms) rendered in Prometheus text format, under the
  JAX package's family names;
* :mod:`.tracing` — a bounded ring-buffer span tracer with parent ids;
* :mod:`.requests` — the per-request ledger the engine stamps phase by
  phase;
* :mod:`.accounting` — the per-tenant resource meter;
* :mod:`.profiling` — bounded trace captures on ``torch.profiler`` and the
  device-memory summary behind ``tpuhive_device_hbm_live_bytes``.

Copies of jax-free modules, on plain ``threading`` locks where JAX uses its
lock witness. The registry, tracer and ledger are process-wide, as in JAX;
:func:`reset_observability` clears them for test isolation.
"""
from __future__ import annotations

from .. import __version__ as _version
from .metrics import (
    DEFAULT_BUCKETS,
    PROCESS_START_TS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    parse_rendered,
    register_process_metrics,
)
from .requests import RequestLedger, RequestRecord, get_request_ledger
from .tracing import Span, SpanLogFilter, SpanTracer

_registry = MetricsRegistry()
_tracer = SpanTracer()

# build info + process self-metrics, refreshed at exposition time
register_process_metrics(_registry, _version)

# per-device live device-memory gauges refreshed at scrape time — inert
# unless profiling is enabled in the port's config and CUDA is initialized
from .profiling import hbm_collector as _hbm_collector  # noqa: E402

_registry.register_collector(_hbm_collector)


def get_registry() -> MetricsRegistry:
    """Process-wide metrics registry."""
    return _registry


def get_tracer() -> SpanTracer:
    """Process-wide span tracer."""
    return _tracer


def reset_observability() -> None:
    """Zero all metric values, drop recorded spans and ledger rows, and drop
    the tenant meter (rebuilt lazily from the config on next use).

    Metric families and their child references stay valid: instrumented
    modules hold family handles created at import, so a reset clears values
    in place."""
    from .accounting import set_tenant_meter

    _registry.reset_values()
    _tracer.clear()
    get_request_ledger().clear()
    set_tenant_meter(None)


__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "PROCESS_START_TS",
    "RequestLedger",
    "RequestRecord",
    "Span",
    "SpanLogFilter",
    "SpanTracer",
    "get_registry",
    "get_request_ledger",
    "get_tracer",
    "parse_rendered",
    "register_process_metrics",
    "reset_observability",
]
