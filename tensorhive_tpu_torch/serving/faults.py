"""Deterministic fault injection for the serving data plane — a copy of
``tensorhive_tpu/serving/faults.py`` (the port imports nothing of the JAX
package), on a plain ``threading.Lock`` where JAX uses its lock witness.

A :class:`ServingFaultPlan` attaches to a
:class:`~tensorhive_tpu_torch.serving.engine.SlotEngine`, and every device
DISPATCH — decode step, prefill (whole-prompt or chunked), speculative
verify, the host tier's page extract and inject — consults it first, so
the failures a card produces (a runtime error, an out-of-memory, a device
lost mid-serving) are reproducible from a seed. Nothing here sleeps or
flakes: latency is modeled through an injectable sleeper, probability
faults are seeded, and ``fail_next`` faults are exact counts consumed in
dispatch order.

The engine writes its cache in place, so the plan is consulted before the
first write of its dispatch: an injected fault leaves the cache as it
was, which is what makes the ``transient`` classification honest for
injected faults.

Failure taxonomy (what :func:`classify_failure` answers):

* **transient** — worth retrying the tick against the SAME engine: the
  dispatch never reached the device, so the engine's state is intact.
  Only failures that declare themselves transient qualify:
  :class:`TransientDispatchError` (and anything with a truthy
  ``transient`` attribute).
* **fatal** — everything else. A real failure inside a dispatch may have
  left the cache half written or the device wedged; the only honest
  recovery is fail-fast (terminal chunks to every in-flight stream) and a
  rebuild of the engine.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Dict, Optional, Type

import threading

#: dispatch kinds a plan can target: the engine's three compute seams and
#: the host tier's page extract and inject (which the JAX plan does not
#: list, though its engine consults the plan there too)
DISPATCH_KINDS = ("step", "prefill", "verify", "extract", "inject")

TRANSIENT = "transient"
FATAL = "fatal"


class InjectedFaultError(RuntimeError):
    """Base class for failures a :class:`ServingFaultPlan` raises — fatal
    unless a subclass says otherwise (the same default real errors get)."""

    transient = False


class TransientDispatchError(InjectedFaultError):
    """A dispatch failure that never reached the device: the engine's
    cache is intact and retrying the tick is safe. A supervisor retries
    these with bounded backoff before escalating."""

    transient = True


class DeviceLostError(InjectedFaultError):
    """The accelerator went away mid-serving (preemption, runtime
    crash) — the canonical fatal fault: every in-flight stream must be
    failed fast and the engine rebuilt on whatever device comes back."""

    transient = False


def classify_failure(exc: BaseException) -> str:
    """``"transient"`` (retry the tick, same engine) or ``"fatal"``
    (fail-fast + rebuild). See the module docstring for why unknown
    errors are fatal by default."""
    if getattr(exc, "transient", False):
        return TRANSIENT
    return FATAL


class ServingFaultPlan:
    """Seeded, deterministic fault schedule for one engine's dispatches.

    Attach via ``SlotEngine(fault_plan=...)``; the engine calls
    :meth:`before_dispatch` at the top of every step, prefill, verify,
    extract and inject dispatch (BEFORE any device call, so an injected
    fault never leaves a half-written cache — which is what makes the
    ``transient`` classification honest for injected faults).

    * :meth:`fail_next` — the next N dispatches of a kind raise the given
      exception class (default :class:`DeviceLostError`, the fatal case);
      exact counts, consumed in dispatch order.
    * ``fail_probability`` — seeded coin per dispatch: deterministic given
      ``seed`` and the dispatch order.
    * :meth:`slow_next` — the next N dispatches of a kind invoke
      ``sleeper(seconds)`` first (a stalling device, not a dead one);
      tests inject a recording sleeper so nothing really waits.
    * :meth:`set_device_lost` — every dispatch raises
      :class:`DeviceLostError` until cleared: the persistent-outage shape
      a crash-loop breaker must survive (clearing it is "the platform
      restored the device").

    Counters (:attr:`dispatches`, :attr:`faults_injected`, per kind) let
    harnesses assert exactly how many dispatches consulted the plan — the
    serving chaos smoke pins fault counts the way the control-plane smoke
    pins breaker streak counts.
    """

    def __init__(self, seed: int = 0, error: str = "injected serving fault",
                 fail_probability: float = 0.0,
                 exc_class: Type[BaseException] = DeviceLostError,
                 sleeper: Callable[[float], None] = time.sleep) -> None:
        self.seed = seed
        self.error = error
        self.fail_probability = float(fail_probability)
        self.exc_class = exc_class
        self._sleeper = sleeper
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._fail_next: Dict[str, list] = {kind: [] for kind in
                                            DISPATCH_KINDS}
        self._slow_next: Dict[str, list] = {kind: [] for kind in
                                            DISPATCH_KINDS}
        self._device_lost = False
        self.dispatches: Dict[str, int] = {kind: 0 for kind in DISPATCH_KINDS}
        self.faults_injected: Dict[str, int] = {kind: 0 for kind in
                                                DISPATCH_KINDS}

    # -- scheduling --------------------------------------------------------
    def fail_next(self, kind: str, count: int = 1,
                  exc_class: Optional[Type[BaseException]] = None) -> None:
        """Fail the next ``count`` dispatches of ``kind`` with
        ``exc_class`` (default: the plan's, default DeviceLostError)."""
        self._check_kind(kind)
        with self._lock:
            self._fail_next[kind].extend(
                [exc_class or self.exc_class] * int(count))

    def slow_next(self, kind: str, count: int = 1,
                  seconds: float = 0.1) -> None:
        """Stall the next ``count`` dispatches of ``kind`` by ``seconds``
        (through the injectable sleeper) before running them."""
        self._check_kind(kind)
        with self._lock:
            self._slow_next[kind].extend([float(seconds)] * int(count))

    def set_device_lost(self, lost: bool = True) -> None:
        """Every dispatch raises DeviceLostError until cleared."""
        with self._lock:
            self._device_lost = lost

    @staticmethod
    def _check_kind(kind: str) -> None:
        if kind not in DISPATCH_KINDS:
            raise ValueError(
                f"unknown dispatch kind {kind!r}; one of {DISPATCH_KINDS}")

    # -- the seam ----------------------------------------------------------
    def before_dispatch(self, kind: str) -> None:
        """Consulted by the engine before every device dispatch; raises the
        planned failure (if any) and applies planned slowness."""
        self._check_kind(kind)
        with self._lock:
            self.dispatches[kind] += 1
            slow_s = (self._slow_next[kind].pop(0)
                      if self._slow_next[kind] else None)
            exc_class: Optional[Type[BaseException]] = None
            reason = None
            if self._device_lost:
                exc_class, reason = DeviceLostError, "device_lost"
            elif self._fail_next[kind]:
                exc_class = self._fail_next[kind].pop(0)
                reason = "fail_next"
            elif (self.fail_probability
                    and self._rng.random() < self.fail_probability):
                exc_class, reason = self.exc_class, "seeded"
            if exc_class is not None:
                self.faults_injected[kind] += 1
        # sleep and raise OUTSIDE the lock: a slow dispatch must not block
        # another thread's counter reads, and exception construction can
        # run arbitrary subclass code
        if slow_s:
            self._sleeper(slow_s)
        if exc_class is not None:
            raise exc_class(f"{self.error} ({kind}: {reason})")


__all__ = [
    "DISPATCH_KINDS",
    "DeviceLostError",
    "FATAL",
    "InjectedFaultError",
    "ServingFaultPlan",
    "TRANSIENT",
    "TransientDispatchError",
    "classify_failure",
]
