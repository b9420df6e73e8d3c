"""Workload-side telemetry emitter — the counterpart of
``tensorhive_tpu/telemetry.py`` on ``torch.cuda``.

A workload (a training loop, the serving pump) constructs a
:class:`TelemetryEmitter` and calls :meth:`~TelemetryEmitter.sample` once
per step; the emitter publishes, at most once per ``min_write_interval_s``,
a drop file ``{metrics_dir}/{name}-{pid}.json`` (default dir
``~/.tpuhive/metrics``, or ``TPUHIVE_METRICS_DIR``) that the host's
monitoring probe reads — the same keys and layout as the JAX emitter's:
``{device index: {"hbm_used_bytes", "hbm_total_bytes",
"duty_cycle_pct"}}``. Device memory in use is
``torch.cuda.memory_allocated`` (PJRT's ``bytes_in_use`` in JAX), the limit
``get_device_properties(...).total_memory`` (``bytes_limit``); duty cycle
is the device-busy share of the window's wall time, as in JAX. The payload
is mirrored into the port's registry (``tpuhive_workload_*``). A device
without memory statistics (the CPU) reports null fields and bumps
``tpuhive_workload_memory_stats_failures_total``; no CPU number stands in
for a device one.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from .device import DeviceLike, resolve_device
from .observability import get_registry

log = logging.getLogger(__name__)

DEFAULT_METRICS_DIR = "~/.tpuhive/metrics"

_HBM_USED = get_registry().gauge(
    "tpuhive_workload_hbm_used_bytes",
    "Per-device HBM bytes in use, from the workload telemetry emitter.",
    labels=("device",))
_HBM_TOTAL = get_registry().gauge(
    "tpuhive_workload_hbm_total_bytes",
    "Per-device HBM capacity in bytes.", labels=("device",))
_DUTY = get_registry().gauge(
    "tpuhive_workload_duty_cycle_pct",
    "Per-device duty-cycle estimate over the last write window (percent).",
    labels=("device",))
_PUBLISHES = get_registry().counter(
    "tpuhive_workload_publishes_total",
    "Successful drop-file publishes by the telemetry emitter.")
_PUBLISH_FAILURES = get_registry().counter(
    "tpuhive_workload_publish_failures_total",
    "Drop-file publishes that failed (I/O errors).")
_MEMORY_STATS_FAILURES = get_registry().counter(
    "tpuhive_workload_memory_stats_failures_total",
    "device.memory_stats() calls that raised (backend without support); "
    "a fleet silently losing HBM metrics shows up here.")

MemoryStats = Callable[[torch.device], Dict[str, int]]


def cuda_memory_stats(device: torch.device) -> Dict[str, int]:
    """``{"bytes_in_use", "bytes_limit"}`` of one card; raises for a device
    that keeps no memory statistics."""
    if device.type != "cuda":
        raise RuntimeError(f"{device} keeps no device memory statistics")
    return {
        "bytes_in_use": torch.cuda.memory_allocated(device),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }


class TelemetryEmitter:
    """Drop-file publisher of one workload. ``device`` None means ``cuda``
    (every visible card is reported, as JAX reports every local device)
    and raises without one; ``memory_stats`` replaces the statistics
    source (tests)."""

    def __init__(
        self,
        name: str = "workload",
        metrics_dir: Optional[str] = None,
        min_write_interval_s: float = 1.0,
        device: DeviceLike = None,
        memory_stats: MemoryStats = cuda_memory_stats,
    ) -> None:
        directory = metrics_dir or os.environ.get("TPUHIVE_METRICS_DIR") \
            or DEFAULT_METRICS_DIR
        self.path = (Path(os.path.expanduser(directory))
                     / f"{name}-{os.getpid()}.json")
        self.min_write_interval_s = min_write_interval_s
        device = resolve_device(device)
        self.devices = ([torch.device("cuda", index)
                         for index in range(torch.cuda.device_count())]
                        if device.type == "cuda" else [device])
        self._memory_stats = memory_stats
        self._last_write = 0.0
        self._window_start: Optional[float] = None
        self._busy_accum_s = 0.0

    def sample(self, step_time_s: Optional[float] = None,
               device_busy_s: Optional[float] = None) -> Optional[Dict]:
        """Accumulate busy time and (rate-limited) publish metrics.

        ``step_time_s``/``device_busy_s`` feed the duty-cycle estimate; busy
        time accumulates across every call, so steps shorter than the write
        interval still sum to the window's true busy share."""
        now = time.monotonic()
        if self._window_start is None:
            self._window_start = now - (step_time_s or 0.0)
        busy = device_busy_s if device_busy_s is not None else step_time_s
        if busy is not None:
            self._busy_accum_s += busy
        if now - self._last_write < self.min_write_interval_s:
            return None

        duty = None
        window = now - self._window_start
        if step_time_s is not None and window > 0:
            duty = max(0.0, min(100.0, 100.0 * self._busy_accum_s / window))
        self._window_start = now
        self._busy_accum_s = 0.0

        metrics = self.collect(duty_cycle_pct=duty)
        if metrics:
            self._mirror_to_registry(metrics)
            self._write(metrics)
            self._last_write = now
        return metrics

    @staticmethod
    def _mirror_to_registry(metrics: Dict[str, Dict]) -> None:
        """Copy the drop-file payload into the registry."""
        for device, values in metrics.items():
            if values.get("hbm_used_bytes") is not None:
                _HBM_USED.labels(device=device).set(values["hbm_used_bytes"])
            if values.get("hbm_total_bytes") is not None:
                _HBM_TOTAL.labels(device=device).set(values["hbm_total_bytes"])
            if values.get("duty_cycle_pct") is not None:
                _DUTY.labels(device=device).set(values["duty_cycle_pct"])

    def collect(self, duty_cycle_pct: Optional[float] = None
                ) -> Dict[str, Dict]:
        """One entry per device index, in the probe's drop-file schema."""
        metrics: Dict[str, Dict] = {}
        for device in self.devices:
            stats: Dict[str, int] = {}
            try:
                stats = self._memory_stats(device) or {}
            except Exception:
                # counted and logged, so HBM metrics missing from a
                # dashboard are diagnosable
                _MEMORY_STATS_FAILURES.inc()
                log.debug("memory stats unavailable for device %s", device,
                          exc_info=True)
            key = str(device.index if device.index is not None else 0)
            metrics[key] = {
                "hbm_used_bytes": stats.get("bytes_in_use"),
                "hbm_total_bytes": stats.get("bytes_limit"),
                "duty_cycle_pct": duty_cycle_pct,
            }
        return metrics

    def _write(self, metrics: Dict) -> None:
        """Atomic publish: a rename never exposes a torn file."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(metrics, fh)
            os.replace(tmp, self.path)
        except OSError:
            self._discard_tmp(tmp)
            _PUBLISH_FAILURES.inc()  # I/O flakiness is expected; swallowed
        except BaseException:
            # the temp file never survives a failed publish
            self._discard_tmp(tmp)
            raise  # programming errors stay loud
        else:
            _PUBLISHES.inc()

    @staticmethod
    def _discard_tmp(tmp: str) -> None:
        try:
            os.unlink(tmp)
        except OSError:
            pass

    def close(self) -> None:
        """Remove the drop file (job teardown)."""
        try:
            self.path.unlink()
        except OSError:
            pass
