"""What a run hands to the metric readers, and the line it prints."""
from __future__ import annotations

import json
import math
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from .trace import Profile


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile of every value (no buckets, no
    interpolation): the smallest value with at least q% of them at or
    below it. None for no values."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


@dataclass
class Request:
    """One request as the client saw it (host clock, seconds)."""
    prompt_len: int
    max_new: int
    due: float
    tokens: List[int] = field(default_factory=list)
    times: List[float] = field(default_factory=list)
    outcome: Optional[str] = None    # completed, refused, error, or None
    prompt: Optional[List[int]] = None
    handle: Any = None

    @property
    def first(self) -> Optional[float]:
        return self.times[0] if self.times else None


@dataclass
class Check:
    value: float
    limit: float

    @property
    def passed(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Run:
    """The run's facts, filled by the traffic driver."""
    config: Dict[str, Any]
    cell: Dict[str, Any]
    setup_s: float = 0.0
    #: the measured window, host clock
    window: tuple = (0.0, 0.0)
    requests: List[Request] = field(default_factory=list)
    #: the window's scheduler ticks: flight-recorder rows with ``traced``
    #: and, per tick, the contexts of the tokens it emitted
    ticks: List[Dict[str, Any]] = field(default_factory=list)
    #: the engine's ``stats()`` at the window's start and end
    stats_before: Dict[str, Any] = field(default_factory=dict)
    stats_after: Dict[str, Any] = field(default_factory=dict)
    #: train steps in the window: (start, end, tokens, traced)
    steps: List[tuple] = field(default_factory=list)
    profile: Optional[Profile] = None
    memory_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    checks: Dict[str, Check] = field(default_factory=dict)
    #: how late the client sent each request after its due time, s
    lateness: List[float] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)

    def window_requests(self) -> List[Request]:
        start, end = self.window
        return [r for r in self.requests if start <= r.due < end]

    @property
    def correct(self) -> bool:
        return (not self.errors and bool(self.checks)
                and all(check.passed for check in self.checks.values()))


def emit(run: Run, metrics: Dict[str, Dict[str, Any]],
         device: Dict[str, Any], trace: bool) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    checks = {name: {"value": (check.value if math.isfinite(check.value)
                               else None), "limit": check.limit}
              for name, check in run.checks.items()}
    for message in run.errors:
        print(f"portbench: error: {message}", file=sys.stderr)
    for name, check in run.checks.items():
        print(f"portbench: check {name} = {check.value!r} (limit "
              f"{check.limit!r}) {'ok' if check.passed else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    result: Dict[str, Any] = {
        "correct": run.correct, "attempted": run.attempted,
        "failed": run.failed, "metrics": metrics, "device": device}
    if trace and run.profile is not None and run.profile.busy_s > 0:
        result["breakdown"] = run.profile.breakdown()
    result["checks"] = checks
    print(json.dumps(result), flush=True)
