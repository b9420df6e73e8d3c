"""Bounded ring-buffer span tracer — a copy of
``tensorhive_tpu/observability/tracing.py`` on a plain ``threading.Lock``
where JAX uses its lock witness.

Spans carry parent ids via a per-thread stack, so a span opened inside a
service tick shows up as a child of that tick without explicit plumbing.
Completed spans land in a fixed-capacity ring buffer (old spans evicted,
O(1) append). Each span gets a process-wide monotone sequence number at
completion time, and the dump is ordered by it. The serving engine records
its queue, prefill and decode spans after the fact
(:meth:`SpanTracer.record_span`), keyed by the request id the ledger rows
carry.
"""
from __future__ import annotations

import collections
import itertools
import logging
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterator, List, Optional


DEFAULT_CAPACITY = 512


@dataclass
class Span:
    span_id: str
    parent_id: Optional[str]
    name: str
    kind: str
    #: wall-clock start (unix seconds) — for humans correlating with logs
    start_ts: float
    #: perf_counter at start — for exact durations
    _started: float = field(repr=False, default=0.0)
    duration_s: Optional[float] = None
    status: str = "ok"
    attrs: Dict[str, str] = field(default_factory=dict)
    #: completion sequence number (monotone across the process)
    seq: int = -1

    def to_dict(self) -> Dict:
        return {
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "name": self.name,
            "kind": self.kind,
            "startTs": round(self.start_ts, 6),
            "durationMs": (round(self.duration_s * 1000, 3)
                           if self.duration_s is not None else None),
            "status": self.status,
            "attrs": dict(self.attrs),
            "seq": self.seq,
        }


class SpanTracer:
    """Thread-safe tracer: start/end pairs or the :meth:`span` context
    manager; completed spans retained in a bounded ring buffer."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._finished: Deque[Span] = collections.deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._seq = itertools.count(1)
        self._local = threading.local()

    # -- thread-local parent stack ------------------------------------------
    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current_span(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    # -- explicit API --------------------------------------------------------
    def start_span(self, name: str, kind: str = "internal",
                   **attrs: object) -> Span:
        parent = self.current_span()
        with self._lock:
            span_id = f"{next(self._ids):08x}"
        span = Span(
            span_id=span_id,
            parent_id=parent.span_id if parent else None,
            name=name,
            kind=kind,
            start_ts=time.time(),
            _started=time.perf_counter(),
            attrs={key: str(value) for key, value in attrs.items()},
        )
        self._stack().append(span)
        return span

    def end_span(self, span: Span, status: str = "ok",
                 **attrs: object) -> Span:
        span.duration_s = time.perf_counter() - span._started
        span.status = status
        for key, value in attrs.items():
            span.attrs[key] = str(value)
        stack = self._stack()
        if span in stack:           # tolerate out-of-order ends across threads
            while stack and stack[-1] is not span:
                stack.pop()
            if stack:
                stack.pop()
        with self._lock:
            span.seq = next(self._seq)
            self._finished.append(span)
        return span

    def record_span(self, name: str, kind: str = "internal", *,
                    start_ts: float, duration_s: float, status: str = "ok",
                    parent_id: Optional[str] = None,
                    **attrs: object) -> Span:
        """Append an already-completed span with explicit timing.

        For phases whose boundaries are observed after the fact from a
        different thread than the one that "owns" them (the serving
        engine's queue/prefill/decode phases complete inside the pump
        thread): a start/end pair would push onto the pump thread's parent
        stack and misparent every span the pump opens while a request is
        in flight. Recording retrospectively keeps the per-thread stacks
        untouched while the ring buffer still gets the span — ordering by
        completion ``seq`` like every other span."""
        with self._lock:
            span_id = f"{next(self._ids):08x}"
        span = Span(
            span_id=span_id,
            parent_id=parent_id,
            name=name,
            kind=kind,
            start_ts=start_ts,
            duration_s=duration_s,
            status=status,
            attrs={key: str(value) for key, value in attrs.items()},
        )
        with self._lock:
            span.seq = next(self._seq)
            self._finished.append(span)
        return span

    # -- context-manager API -------------------------------------------------
    @contextmanager
    def span(self, name: str, kind: str = "internal",
             **attrs: object) -> Iterator[Span]:
        span = self.start_span(name, kind, **attrs)
        try:
            yield span
        except BaseException:
            self.end_span(span, status="error")
            raise
        else:
            self.end_span(span, status=span.status)

    # -- reading -------------------------------------------------------------
    def recent(self, limit: Optional[int] = None,
               kind: Optional[str] = None) -> List[Dict]:
        """Completed spans, oldest first (monotone ``seq``/end order)."""
        with self._lock:
            spans = list(self._finished)
        if kind is not None:
            spans = [span for span in spans if span.kind == kind]
        if limit is not None and limit >= 0:
            spans = spans[-limit:]
        return [span.to_dict() for span in spans]

    def __len__(self) -> int:
        with self._lock:
            return len(self._finished)

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()


class SpanLogFilter(logging.Filter):
    """Injects the id of the thread's current span into every log record as
    ``record.span_id`` (empty string when no span is open), so a log format
    containing ``%(span_id)s`` makes ``log.exception`` lines joinable
    against the tracer's dump. Attach it to a handler, so every record
    passing through it carries the attribute whatever its logger."""

    def __init__(self, tracer: Optional[SpanTracer] = None) -> None:
        super().__init__()
        self._tracer = tracer

    def filter(self, record: logging.LogRecord) -> bool:
        tracer = self._tracer
        if tracer is None:
            # late-bound so the filter follows tracer swaps in tests
            from . import get_tracer

            tracer = get_tracer()
        span = tracer.current_span()
        record.span_id = span.span_id if span is not None else ""
        return True
