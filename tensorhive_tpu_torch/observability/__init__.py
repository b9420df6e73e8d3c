"""Observability of the port: so far the latency histogram the serving
engine reads for its ``stats()`` quantiles and its Retry-After estimates
(``metrics.Histogram``). The registry, the request ledger, the tracer and
the tenant meter of ``tensorhive_tpu/observability/`` are not ported
yet."""
