"""On-demand device profiling: bounded trace captures and live
device-memory snapshots — the counterpart of
``tensorhive_tpu/observability/profiling.py`` on ``torch.profiler`` and
``torch.cuda``'s allocator statistics.

* :func:`capture_trace` runs ``torch.profiler`` (CPU and, with a card,
  CUDA activity) around a bounded sleep, so the serving traffic of the next
  N seconds lands in a Chrome-trace JSON under the artifact dir. The card's
  kernels are recorded whichever thread launched them (the serving pump
  runs on a thread of its own); host-side ops only from the calling
  thread. (``profile_all_threads``, which records every thread's ops, is
  experimental in PyTorch, and with it some later sessions in a process
  that had run the pump recorded no device activity at all.)
  **Single-flight**: the device profiler is process-wide, so a second
  concurrent capture is refused (:class:`ProfileInFlightError`).
  Late in a long process (an H100 serving the 7b preset after minutes of
  earlier profiler sessions), sessions came back with every runtime
  record and not one kernel record, for up to 38 captures in a row, or
  with no record of the card at all; earlier in the same process kineto
  had warned of kernels timed 0.27 ms before their launches (the card's
  timestamps skewed against the host's). With ``TEARDOWN_CUPTI=1`` kineto
  finalizes CUPTI after every session and the next one starts afresh: a
  capture sets it unless the environment already chose, and takes itself
  again (up to ``CAPTURE_ATTEMPTS`` in all) when its device side came back
  broken. The metadata says how many attempts it took and how many device
  events the trace holds.
* :func:`device_memory_summary` reads ``torch.cuda.memory_stats`` per
  device — live bytes and live allocations of the caching allocator —
  and exports them as ``tpuhive_device_hbm_live_bytes{device}``.
* :func:`capture_from_config` is the gate the JAX package keeps in its
  admin controller: with ``Config.profiling.enabled`` false it raises
  :class:`ProfileUnavailableError`.

The JAX module also parses ``jax.profiler.device_memory_profile()``, a
gzipped pprof blob, with a small protobuf walk. PyTorch produces no such
blob (its allocator reports its counts directly), so that parser is not
copied.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType

from .metrics import MetricsRegistry

log = logging.getLogger(__name__)

#: hard ceiling no config can raise — a "profile for an hour" typo must not
#: leave the process-wide profiler wedged for an hour
ABSOLUTE_MAX_DURATION_S = 60.0


class ProfileInFlightError(Exception):
    """A trace capture is already running (the profiler is process-wide)."""


class ProfileUnavailableError(Exception):
    """Profiling is disabled by config, or the profiler cannot start."""


# -- trace capture (single-flight) -------------------------------------------

_capture_lock = threading.Lock()

#: captures taken before one whose device records came back is given up
CAPTURE_ATTEMPTS = 3


def _activities() -> List[torch.profiler.ProfilerActivity]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        # kineto finalizes CUPTI after each session: the next one starts
        # with the card's clock synchronized afresh
        os.environ.setdefault("TEARDOWN_CUPTI", "1")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


def _device_records(profiler) -> Optional[int]:
    """Device records (kernels, copies, sets) in a stopped capture, or None
    when its device side came back broken: kernels launched and not one
    device record, or not one CUDA API record (the capture's own
    synchronize makes one). 0 without a card."""
    if not torch.cuda.is_available():
        return 0
    calls = launched = recorded = 0
    for event in profiler.profiler.kineto_results.events():
        if event.device_type() == DeviceType.CUDA:
            recorded += 1
        elif event.name().startswith("cu"):     # cudaX and cuX API calls
            calls += 1
            launched += "Launch" in event.name()
    return None if not recorded and (launched or not calls) else recorded


def capture_trace(artifact_dir: str, duration_s: float,
                  max_duration_s: float = ABSOLUTE_MAX_DURATION_S,
                  sleep: Callable[[float], None] = time.sleep,
                  tracer=None) -> Dict:
    """Capture one bounded ``torch.profiler`` trace into ``artifact_dir``.

    Blocks the calling thread for ``duration_s`` (validated against both
    the configured and the absolute ceiling) while every thread's device
    activity is recorded, then writes the Chrome trace
    (``trace-<utc>-<pid>.json``). Returns artifact metadata (dir, files,
    bytes)."""
    if not duration_s > 0:
        raise ValueError(f"durationS must be > 0, got {duration_s}")
    ceiling = min(float(max_duration_s), ABSOLUTE_MAX_DURATION_S)
    if duration_s > ceiling:
        raise ValueError(
            f"durationS {duration_s} exceeds the capture ceiling {ceiling}s "
            "(profiling max_duration_s)")
    if not _capture_lock.acquire(blocking=False):
        raise ProfileInFlightError(
            "a profile capture is already in flight — the device profiler "
            "is process-wide; retry when it finishes")
    try:
        target = Path(artifact_dir)
        target.mkdir(parents=True, exist_ok=True)
        started_ts = time.time()
        started = time.perf_counter()
        for attempt in range(1, CAPTURE_ATTEMPTS + 1):
            profiler = torch.profiler.profile(activities=_activities())
            try:
                profiler.start()
            except Exception as exc:
                raise ProfileUnavailableError(
                    f"cannot start the device profiler: "
                    f"{type(exc).__name__}: {exc}") from exc
            try:
                sleep(duration_s)
            finally:
                if torch.cuda.is_available() and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                profiler.stop()
            recorded = _device_records(profiler)
            if recorded is not None:
                break
            log.warning("profile capture %d of %d: the card's records did "
                        "not come back%s", attempt, CAPTURE_ATTEMPTS,
                        "; capturing again" if attempt < CAPTURE_ATTEMPTS
                        else "")
        elapsed_s = time.perf_counter() - started
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(started_ts))
        path = target / f"trace-{stamp}-{os.getpid()}.json"
        profiler.export_chrome_trace(str(path))
        files = _artifact_files(target, newer_than=started_ts)
        total_bytes = sum(size for _, size in files)
        result = {
            "artifactDir": str(target),
            "durationS": round(elapsed_s, 3),
            "startedTs": round(started_ts, 3),
            "files": [name for name, _ in files],
            "bytes": total_bytes,
            "attempts": attempt,
            "deviceEvents": recorded or 0,
        }
        if tracer is not None:
            tracer.record_span("profile.capture", kind="profile",
                               start_ts=started_ts, duration_s=elapsed_s,
                               artifact_dir=str(target), bytes=total_bytes)
        log.info("profile capture: %.2fs -> %s (%d files, %d bytes)",
                 elapsed_s, target, len(files), total_bytes)
        return result
    finally:
        _capture_lock.release()


def capture_in_flight() -> bool:
    """Whether a trace capture currently holds the single-flight lock (read
    without taking it: the serving engine asks every tick, and a capture
    that began at that instant would otherwise be refused)."""
    return _capture_lock.locked()


def capture_from_config(config, duration_s: Optional[float] = None,
                        tracer=None) -> Dict:
    """:func:`capture_trace` behind the port config's ``profiling``
    section: refused with :class:`ProfileUnavailableError` while it is
    disabled; ``duration_s`` None takes its default, and its
    ``max_duration_s`` is the ceiling."""
    profiling = config.profiling
    if not profiling.enabled:
        raise ProfileUnavailableError(
            "profiling is disabled (Config.profiling.enabled)")
    return capture_trace(
        str(config.profile_artifact_dir),
        profiling.default_duration_s if duration_s is None else duration_s,
        max_duration_s=profiling.max_duration_s, tracer=tracer)


def _artifact_files(root: Path,
                    newer_than: float) -> List[Tuple[str, int]]:
    """Profiler output files under ``root`` written by this capture
    (mtime-filtered: repeated captures share the dir), relative paths."""
    files = []
    for path in sorted(root.rglob("*")):
        if not path.is_file():
            continue
        stat = path.stat()
        # 1 s slack: coarse filesystem mtime granularity
        if stat.st_mtime >= newer_than - 1.0:
            files.append((str(path.relative_to(root)), stat.st_size))
    return files


# -- device memory -------------------------------------------------------------

def _per_device_memory() -> Dict[str, Dict[str, int]]:
    """``{device: {"liveBytes", "allocations"}}`` from the caching
    allocator of every visible card."""
    per_device: Dict[str, Dict[str, int]] = {}
    for index in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(index)
        per_device[f"cuda:{index}"] = {
            "liveBytes": int(stats.get("allocated_bytes.all.current", 0)),
            "allocations": int(stats.get("allocation.all.current", 0)),
        }
    return per_device


def device_memory_summary(
        registry: Optional[MetricsRegistry] = None) -> Dict:
    """One snapshot of per-device live bytes and live allocations (gauged as
    ``tpuhive_device_hbm_live_bytes{device}`` when a registry is given).
    Raises :class:`ProfileUnavailableError` without a card."""
    if not torch.cuda.is_available():
        raise ProfileUnavailableError(
            "no CUDA device: there is no device memory to summarize")
    per_device = _per_device_memory()
    if registry is not None:
        _set_live_bytes_gauges(registry, per_device)
    devices = [{"device": device, "liveBytes": entry["liveBytes"],
                "allocations": entry["allocations"]}
               for device, entry in sorted(per_device.items())]
    return {
        "capturedTs": round(time.time(), 3),
        "devices": devices,
        "totalLiveBytes": sum(d["liveBytes"] for d in devices),
    }


def _set_live_bytes_gauges(registry: MetricsRegistry,
                           per_device: Dict[str, Dict[str, int]]) -> None:
    family = registry.gauge(
        "tpuhive_device_hbm_live_bytes",
        "Live device-memory bytes per device from the CUDA caching "
        "allocator — the scrapeable HBM-growth signal that correlates with "
        "the KV-pages gauges.",
        labels=("device",))
    for device, entry in per_device.items():
        family.labels(device=device).set(entry["liveBytes"])


def hbm_collector(registry: MetricsRegistry) -> None:
    """Registry collector: refresh the live-bytes gauges at scrape time.
    Inert unless profiling is enabled in the port's config and CUDA is
    already initialized in the process (a scrape never initializes a
    card), and while a capture is in flight."""
    from ..config import get_config

    if not get_config().profiling.enabled:
        return
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return
    if capture_in_flight():
        return
    _set_live_bytes_gauges(registry, _per_device_memory())
