"""The traced run's profile: a fixed span in the middle of the window (a
few train steps or serving ticks) under ``torch.profiler``, reduced from
the raw records to what the per-layer metrics and ``breakdown`` read.

On the card the profiler records the device's operations and the CUDA
runtime's calls only (recording every host operator as well slowed a
decode tick threefold and made the idle share the profiler's own). The
harness's spans (``portbench.step``, ``portbench.submit``,
``portbench.batch``, ``portbench.train_step``) and the profiled span are
timed by the harness on the wall clock the profiler's records use. Busy
time is the union of the device's operation intervals inside the span,
which ends after a device synchronize. An idle gap is labelled with what
the host was doing when it began: the harness span that was open and the
CUDA call in flight, if any.
"""
from __future__ import annotations

import bisect
import contextlib
import re
import time
from typing import Dict, List, Optional, Tuple

#: device kernels grouped as cuBLAS's GEMMs
GEMM_TAGS = ("gemm", "nvjet", "cutlass", "xmma")
#: the port's hand-written kernels keep their own names
PORT_PREFIXES = ("paged_decode", "flash_")
#: a gap begun outside any CUDA call: host work in Python and the operators
HOST = "host (no CUDA call)"


def kernel_group(name: str) -> str:
    """The name a device operation is summed under in ``breakdown``."""
    lowered = name.lower()
    base = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    base = base.split("(")[0].split("<")[0].strip()
    if any(base.startswith(prefix) for prefix in PORT_PREFIXES):
        return base
    if any(tag in lowered for tag in GEMM_TAGS):
        return "gemm (cuBLAS)"
    if lowered.startswith("memcpy") or lowered.startswith("memset"):
        return name.split(" ")[0]
    return base or name


class Profile:
    """The reduced trace of one span."""

    def __init__(self) -> None:
        self.window_s = 0.0
        self.busy_s = 0.0
        #: (name, start_s, duration_s) of every device operation, start
        #: relative to the span's
        self.device_ops: List[Tuple[str, float, float]] = []
        self.idle_gaps: List[Tuple[str, float]] = []
        self.units = 0          # ticks or steps the span covered
        #: which of the tracer's spans this is (``Tracer.session``)
        self.session = 0

    def device_seconds(self, names: Tuple[str, ...]) -> float:
        """Device time of the operations whose name contains one of
        ``names``."""
        return sum(duration for name, _, duration in self.device_ops
                   if any(tag in name for tag in names))

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        totals: Dict[str, float] = {}
        for name, _, duration in self.device_ops:
            group = kernel_group(name)
            totals[group] = totals.get(group, 0.0) + duration
        ops = sorted(totals.items(), key=lambda item: -item[1])[:top]
        gaps: Dict[str, float] = {}
        for label, seconds in self.idle_gaps:
            gaps[label] = gaps.get(label, 0.0) + seconds
        idle = sorted(gaps.items(), key=lambda item: -item[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


def reduce(prof, begin: int, end: int,
           spans: List[Tuple[str, int, int]], units: int) -> Profile:
    """The span [begin, end] (wall clock, ns): busy time, device
    operations and idle gaps labelled by the harness span and the CUDA
    call open when each began."""
    from torch.autograd import DeviceType

    from .env import log

    out = Profile()
    out.units = units
    out.window_s = (end - begin) / 1e9
    host = []
    device = []
    for event in prof.profiler.kineto_results.events():
        if event.device_type() == DeviceType.CUDA:
            if not event.is_user_annotation():
                device.append((event.start_ns(), event.duration_ns(),
                               event.name()))
        else:
            host.append((event.start_ns(), event.start_ns()
                         + event.duration_ns(), event.name()))
    device.sort()
    if device:
        log(f"trace: {len(device)} device and {len(host)} host records; "
            f"first device record {(device[0][0] - begin) / 1e6:.3f} ms "
            f"after the span's start, last ends "
            f"{(end - device[-1][0] - device[-1][1]) / 1e6:.3f} ms before "
            f"its end")
    busy = 0
    cursor = begin
    gaps: List[Tuple[int, int]] = []
    for start, duration, name in device:
        stop = start + duration
        if stop <= begin or start >= end:
            continue
        out.device_ops.append((name, (start - begin) / 1e9, duration / 1e9))
        start, stop = max(start, begin), min(stop, end)
        if start > cursor:
            gaps.append((cursor, start))
        if stop > cursor:
            busy += stop - max(start, cursor)
            cursor = stop
    if end > cursor:
        gaps.append((cursor, end))
    out.busy_s = busy / 1e9
    # every gap labelled: the harness spans do not overlap, nor do the
    # CUDA calls on the host thread, so the one open at a time is the last
    # to begin before it, if it has not ended
    host.sort()
    spans = sorted(spans, key=lambda span: span[1])
    host_starts = [start for start, _, _ in host]
    span_starts = [start for _, start, _ in spans]
    for gap_start, gap_stop in gaps:
        label = HOST
        index = bisect.bisect_right(host_starts, gap_start) - 1
        if index >= 0 and host[index][1] > gap_start:
            label = host[index][2]
        index = bisect.bisect_right(span_starts, gap_start) - 1
        if index >= 0 and spans[index][2] > gap_start:
            label = f"{spans[index][0]} / {label}"
        out.idle_gaps.append((label, (gap_stop - gap_start) / 1e9))
    return out


class Tracer:
    """Arms a profile of ``units`` ticks or steps once the window is half
    gone; when the span comes back with no device record (CUPTI's lost
    sessions), it arms again on the next ones, up to ``attempts``."""

    def __init__(self, enabled: bool, units: int, attempts: int = 3) -> None:
        self.enabled = enabled
        self.units = units
        self.attempts = attempts
        self.result: Optional[Profile] = None
        self._prof = None
        self._count = 0
        self._begin = 0
        self._spans: List[Tuple[str, int, int]] = []
        self._session = 0

    @property
    def active(self) -> bool:
        return self._prof is not None

    @property
    def session(self) -> int:
        """The running span's number (1, 2, .. as spans are retried), 0
        when none runs: a tick records it, so a reader takes the ticks of
        the span that made ``result``."""
        return self._session if self.active else 0

    @contextlib.contextmanager
    def span(self, name: str):
        """A harness span, kept while a profile runs."""
        if not self.active:
            yield
            return
        start = time.time_ns()
        try:
            yield
        finally:
            self._spans.append((name, start, time.time_ns()))

    def before(self, elapsed: float, seconds: float) -> None:
        if (not self.enabled or self.active or self.result is not None
                or self.attempts <= 0 or elapsed < seconds / 2):
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        card = torch.cuda.is_available()
        if card:
            torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA] if card
                             else [ProfilerActivity.CPU])
        self._prof.__enter__()
        self._count = 0
        self._spans = []
        self._session += 1
        self.attempts -= 1
        self._begin = time.time_ns()

    def after(self) -> None:
        if not self.active:
            return
        import torch

        self._count += 1
        if self._count < self.units:
            return
        card = torch.cuda.is_available()
        if card:
            torch.cuda.synchronize()
        end = time.time_ns()
        self._prof.__exit__(None, None, None)
        profile = reduce(self._prof, self._begin, end, self._spans,
                         self._count)
        profile.session = self._session
        self._prof = None
        from .env import log
        log(f"trace: {self._count} units, busy {profile.busy_s!r} of "
            f"{profile.window_s!r} s")
        if profile.busy_s > 0 or self.attempts <= 0 or not card:
            self.result = profile

    def close(self) -> None:
        """Stop a span the run ended inside."""
        if self.active:
            self._count = self.units - 1
            self.attempts = 0
            self.after()


def idle_percent(profile: Optional[Profile]) -> Optional[float]:
    """One minus the busy share of a profiled span, in percent (None when
    the span holds no device record)."""
    if profile is None or profile.window_s <= 0 or profile.busy_s <= 0:
        return None
    return 100.0 * (1.0 - profile.busy_s / profile.window_s)
