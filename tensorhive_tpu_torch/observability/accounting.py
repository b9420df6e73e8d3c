"""Tenant attribution: per-tenant resource x time metering — a copy of
the serving half of ``tensorhive_tpu/observability/accounting.py``.

One :class:`TenantMeter` integrates *resource x time* products per tenant:
the :class:`~tensorhive_tpu_torch.serving.engine.SlotEngine` pump thread
stamps device-seconds (busy slot-seconds x devices), HBM-byte-seconds
(resident KV pages x bytes per page, host-tier bytes metered apart),
queue-seconds and token counters (prefill/decode/cached/speculative
accepted), keyed by the request ledger's ``userKey``. Pure host
bookkeeping.

The JAX package also feeds reservation chip-seconds from its
``UsageLoggingService`` (a control-plane daemon writing to the database);
that feed is not part of the port, so ``charge_reservation`` exists only so
the exported families keep JAX's shape.

Rollups answer "who consumed which fraction of the device over the last
hour": totals are snapshotted on a coarse cadence so ``rollup(window_s)``
returns the delta against the snapshot at the window's left edge. Export is
bounded: the ``tpuhive_tenant_*`` counter families carry the top-K tenants
by lifetime device-seconds plus one ``other`` overflow bucket.

``Config.accounting.enabled = False`` (the port's config) makes
:func:`get_tenant_meter` return ``None``: every instrumentation site takes
its meter-less path and the collector publishes no children.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, fields
from typing import Callable, Deque, Dict, List, Mapping, Optional, Tuple


log = logging.getLogger(__name__)

#: label value of the overflow bucket that absorbs every tenant outside
#: the top-K by lifetime device-seconds
OVERFLOW_TENANT = "other"

#: tenant key for serving requests submitted without a user key (bare
#: library use / unauthenticated test traffic)
ANONYMOUS_TENANT = "anonymous"

#: ``kind`` label values of ``tpuhive_tenant_tokens_total``
TOKEN_KINDS = ("prefill", "decode", "cached", "spec_accepted")


@dataclass
class TenantUsage:
    """Cumulative resource·time products for one tenant (all monotonic)."""

    device_seconds: float = 0.0         # busy slot-seconds x mesh devices
    kv_byte_seconds: float = 0.0        # HBM-resident KV bytes x seconds
    host_kv_byte_seconds: float = 0.0   # host-tier (parked/demoted) bytes x s
    queue_seconds: float = 0.0          # admission-queue wait
    prefill_tokens: float = 0.0         # prompt tokens actually computed
    decode_tokens: float = 0.0          # emitted decode tokens
    cached_tokens: float = 0.0          # prompt tokens served from the radix cache
    spec_accepted_tokens: float = 0.0   # draft tokens accepted by the verifier
    reserved_chip_seconds: float = 0.0  # reservation wall-clock x chips
    effective_chip_seconds: float = 0.0  # duty-cycle-weighted chip-seconds

    def copy(self) -> "TenantUsage":
        return TenantUsage(**{f.name: getattr(self, f.name)
                              for f in fields(self)})

    def add(self, other: "TenantUsage") -> None:
        for f in fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))

    def delta(self, baseline: Optional["TenantUsage"]) -> "TenantUsage":
        """``self - baseline`` clamped at zero per component."""
        if baseline is None:
            return self.copy()
        out = TenantUsage()
        for f in fields(self):
            out_v = getattr(self, f.name) - getattr(baseline, f.name)
            setattr(out, f.name, out_v if out_v > 0.0 else 0.0)
        return out

    def is_zero(self) -> bool:
        return all(getattr(self, f.name) == 0.0 for f in fields(self))

    def to_dict(self) -> Dict[str, float]:
        return {f.name: getattr(self, f.name) for f in fields(self)}


class TenantMeter:
    """Thread-safe per-tenant resource·time accumulator with windowed
    rollups and a bounded-cardinality export view.

    The meter's lock is a **leaf**: callers (the engine pump, after the
    engine lock is released, and the metrics collector) only ever take it
    last and never call out while holding it.
    """

    def __init__(self, top_k: int = 8, window_s: float = 3600.0,
                 snapshot_interval_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.top_k = int(top_k)
        self.window_s = float(window_s)
        # default cadence: ~120 baselines across the default window; a
        # bounded deque caps memory no matter how long the process lives
        if snapshot_interval_s is None:
            snapshot_interval_s = max(1.0, self.window_s / 120.0)
        self.snapshot_interval_s = float(snapshot_interval_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._totals: Dict[str, TenantUsage] = {}
        maxlen = int(self.window_s / self.snapshot_interval_s) + 8
        self._snapshots: Deque[Tuple[float, Dict[str, TenantUsage]]] = \
            deque(maxlen=maxlen)
        self._last_snapshot_ts: Optional[float] = None

    # -- internals ------------------------------------------------------------
    def _usage_locked(self, tenant: str) -> TenantUsage:
        usage = self._totals.get(tenant)
        if usage is None:
            usage = TenantUsage()
            self._totals[tenant] = usage
        return usage

    def _maybe_snapshot_locked(self) -> None:
        now = self.clock()
        if (self._last_snapshot_ts is not None
                and now - self._last_snapshot_ts < self.snapshot_interval_s):
            return
        self._last_snapshot_ts = now
        self._snapshots.append(
            (now, {t: u.copy() for t, u in self._totals.items()}))

    # -- serving-plane feeds --------------------------------------------------
    def charge_tick(self, charges: Mapping[str, Tuple[float, float, float]]
                    ) -> None:
        """One engine pump tick: ``{tenant: (device_s, kv_byte_s,
        host_kv_byte_s)}`` computed by the caller from a single dt
        sample, so conservation against the engine's own busy
        slot-second integral is exact."""
        if not charges:
            return
        with self._lock:
            for tenant, (device_s, kv_byte_s, host_kv_byte_s) in \
                    charges.items():
                usage = self._usage_locked(tenant)
                usage.device_seconds += device_s
                usage.kv_byte_seconds += kv_byte_s
                usage.host_kv_byte_seconds += host_kv_byte_s
            self._maybe_snapshot_locked()

    def charge_queue(self, tenant: str, seconds: float) -> None:
        if seconds <= 0:
            return
        with self._lock:
            self._usage_locked(tenant).queue_seconds += seconds
            self._maybe_snapshot_locked()

    def count_tokens(self, tenant: str, kind: str, n: float) -> None:
        if n <= 0:
            return
        if kind not in TOKEN_KINDS:
            raise ValueError(f"unknown token kind {kind!r}; "
                             f"expected one of {TOKEN_KINDS}")
        with self._lock:
            usage = self._usage_locked(tenant)
            setattr(usage, f"{kind}_tokens",
                    getattr(usage, f"{kind}_tokens") + n)
            self._maybe_snapshot_locked()

    # -- reservation-plane feed -----------------------------------------------
    def charge_reservation(self, tenant: str, chip_seconds: float,
                           effective_chip_seconds: Optional[float] = None
                           ) -> None:
        if chip_seconds <= 0:
            return
        with self._lock:
            usage = self._usage_locked(tenant)
            usage.reserved_chip_seconds += chip_seconds
            if effective_chip_seconds is not None \
                    and effective_chip_seconds > 0:
                usage.effective_chip_seconds += effective_chip_seconds
            self._maybe_snapshot_locked()

    # -- reads ----------------------------------------------------------------
    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._totals)

    def totals(self) -> Dict[str, TenantUsage]:
        with self._lock:
            return {t: u.copy() for t, u in self._totals.items()}

    def rollup(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> Dict[str, TenantUsage]:
        """Per-tenant usage over the trailing window: current totals
        minus the newest snapshot at or before ``now - window_s``
        (missing baseline = process-lifetime totals)."""
        if window_s is None:
            window_s = self.window_s
        with self._lock:
            if now is None:
                now = self.clock()
            cutoff = now - window_s
            baseline: Dict[str, TenantUsage] = {}
            for ts, snap in self._snapshots:
                if ts <= cutoff:
                    baseline = snap
                else:
                    break
            out: Dict[str, TenantUsage] = {}
            for tenant, usage in self._totals.items():
                d = usage.delta(baseline.get(tenant))
                if not d.is_zero():
                    out[tenant] = d
            return out

    def export_totals(self) -> Dict[str, TenantUsage]:
        """Bounded-cardinality view for the metric exporter: the top-K
        tenants by lifetime device-seconds keep their identity, the
        rest collapse into :data:`OVERFLOW_TENANT` — at most K+1 keys.
        ``other`` only exists while there is overflow."""
        with self._lock:
            ranked = sorted(
                self._totals.items(),
                key=lambda item: (-item[1].device_seconds, item[0]))
            out: Dict[str, TenantUsage] = {}
            overflow: Optional[TenantUsage] = None
            for rank, (tenant, usage) in enumerate(ranked):
                if rank < self.top_k:
                    out[tenant] = usage.copy()
                else:
                    if overflow is None:
                        overflow = TenantUsage()
                    overflow.add(usage)
            if overflow is not None:
                out[OVERFLOW_TENANT] = overflow
            return out


# -- process-wide meter + config lifecycle ------------------------------------
_meter: Optional[TenantMeter] = None
_meter_built = False
_meter_lock = threading.Lock()


def get_tenant_meter() -> Optional[TenantMeter]:
    """Process-wide meter, built lazily from the port's
    ``Config.accounting`` — or ``None`` while accounting is disabled (every
    caller's meter-less path)."""
    global _meter, _meter_built
    from ..config import get_config

    with _meter_lock:
        if not _meter_built:
            _meter_built = True
            accounting = get_config().accounting
            _meter = (TenantMeter(top_k=accounting.top_k_tenants,
                                  window_s=accounting.window_s)
                      if accounting.enabled else None)
        return _meter


def set_tenant_meter(meter: Optional[TenantMeter]) -> None:
    """Install a meter, or ``None`` to drop state and rebuild lazily from
    the config on the next :func:`get_tenant_meter`."""
    global _meter, _meter_built
    with _meter_lock:
        _meter = meter
        _meter_built = meter is not None


# -- alert source -------------------------------------------------------------

def dominance_signal(now: Optional[float] = None) -> Optional[float]:
    """Alert source for ``tenant_dominates_capacity``: the largest
    single-tenant share of attributed device-seconds over the accounting
    window, but only while queue-wait SLO pressure exists (p95 admission
    wait of the port's published engine above
    ``GenerationConfig.queue_wait_slo_s``) — a dominant tenant on an idle
    device is not a noisy neighbour. ``None`` when accounting is off, no
    engine is published, the queue is healthy, or the window attributed
    nothing."""
    from ..config import get_config
    from ..serving import get_engine

    meter = get_tenant_meter()
    if meter is None:
        return None
    engine = get_engine()
    if engine is None:
        return None
    queue_wait_slo_s = get_config().generation.queue_wait_slo_s
    p95 = engine.queue_wait_p95_s()
    if p95 is None or p95 <= queue_wait_slo_s:
        return None
    rollup = meter.rollup(now=now)
    total = sum(u.device_seconds for u in rollup.values())
    if total <= 0:
        return None
    return max(u.device_seconds for u in rollup.values()) / total


# -- metric export ------------------------------------------------------------

def _sync_counter_family(family, desired: Mapping[Tuple[str, ...], float]
                         ) -> None:
    """Drive a counter family to absolute per-child targets and drop
    every child outside ``desired`` (cardinality bound). Safe only
    because the accounting collector is the sole writer of the tenant
    families: a target below the child's current value (top-K
    membership change shrinking ``other``) re-creates the child — a
    plain Prometheus counter reset."""
    current = {key: child.value for key, child in family.children()}
    keep = [key for key, value in current.items()
            if key in desired and desired[key] >= value]
    family.retain_children(keep)
    for key, target in desired.items():
        if target <= 0:
            continue
        child = family.labels(**dict(zip(family.label_names, key)))
        delta = target - child.value
        if delta > 0:
            child.inc(delta)


def _register_exports():
    from . import get_registry

    registry = get_registry()
    device = registry.counter(
        "tpuhive_tenant_device_seconds_total",
        "Busy slot-seconds x mesh devices attributed per tenant "
        "(top-K by device-seconds + an 'other' overflow bucket; "
        "K = [accounting] top_k_tenants).",
        labels=("tenant",))
    kv = registry.counter(
        "tpuhive_tenant_kv_byte_seconds_total",
        "HBM-resident KV-cache byte-seconds per tenant (int8-aware via "
        "kv_bytes_per_token; same top-K + 'other' bound).",
        labels=("tenant",))
    host_kv = registry.counter(
        "tpuhive_tenant_host_kv_byte_seconds_total",
        "Host-RAM-tier KV byte-seconds per tenant (parked slots whose "
        "pages were demoted to the host store).",
        labels=("tenant",))
    queue = registry.counter(
        "tpuhive_tenant_queue_seconds_total",
        "Admission-queue wait seconds per tenant.",
        labels=("tenant",))
    tokens = registry.counter(
        "tpuhive_tenant_tokens_total",
        "Tokens per tenant split by kind: prefill | decode | cached | "
        "spec_accepted.",
        labels=("tenant", "kind"))
    reserved = registry.counter(
        "tpuhive_tenant_reserved_chip_seconds_total",
        "Reservation wall-clock chip-seconds per owner "
        "(UsageLoggingService cadence x reserved chips).",
        labels=("tenant",))
    effective = registry.counter(
        "tpuhive_tenant_effective_chip_seconds_total",
        "Duty-cycle-weighted reservation chip-seconds per owner — the "
        "chips actually exercised, not merely held.",
        labels=("tenant",))

    def _collect_tenant_usage(_registry) -> None:
        meter = get_tenant_meter()
        if meter is None:
            # disabled: publish nothing; families with zero children are
            # skipped by render(), so the rollback emits zero series
            for family in (device, kv, host_kv, queue, tokens, reserved,
                           effective):
                family.retain_children(())
            return
        export = meter.export_totals()
        _sync_counter_family(device, {
            (t,): u.device_seconds for t, u in export.items()})
        _sync_counter_family(kv, {
            (t,): u.kv_byte_seconds for t, u in export.items()})
        _sync_counter_family(host_kv, {
            (t,): u.host_kv_byte_seconds for t, u in export.items()})
        _sync_counter_family(queue, {
            (t,): u.queue_seconds for t, u in export.items()})
        _sync_counter_family(tokens, {
            (t, kind): getattr(u, f"{kind}_tokens")
            for t, u in export.items() for kind in TOKEN_KINDS})
        _sync_counter_family(reserved, {
            (t,): u.reserved_chip_seconds for t, u in export.items()})
        _sync_counter_family(effective, {
            (t,): u.effective_chip_seconds for t, u in export.items()})

    registry.register_collector(_collect_tenant_usage)


_register_exports()
