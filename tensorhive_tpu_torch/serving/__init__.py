"""Serving subsystem of the port: continuous batching over the paged decode
path. A copy of ``tensorhive_tpu/serving/__init__.py``'s admission errors
and process-wide engine slot (the port imports nothing of the JAX package).

The process-wide engine is set in one place (the caller that builds it)
and read by whoever serves traffic; ``get_engine`` never constructs.
"""
from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .engine import SlotEngine


class AdmissionError(Exception):
    """Base for load-shedding rejections; carries the Retry-After hint an
    API layer surfaces on its 429 response."""

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 request_id: Optional[str] = None) -> None:
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.request_id = request_id


class QueueFullError(AdmissionError):
    """Admission queue is at capacity (429)."""


class RateLimitError(AdmissionError):
    """Per-user concurrency cap exceeded (429)."""


class EngineDrainingError(AdmissionError):
    """The engine is draining: no new admissions while in-flight requests
    finish (503)."""


__all__ = [
    "AdmissionError",
    "EngineDrainingError",
    "QueueFullError",
    "RateLimitError",
    "get_engine",
    "set_engine",
]

_engine: Optional["SlotEngine"] = None
_engine_lock = threading.Lock()


def get_engine() -> Optional["SlotEngine"]:
    """The process-wide serving engine, or None when serving is off."""
    with _engine_lock:
        return _engine


def set_engine(engine: Optional["SlotEngine"]) -> None:
    """Install (or with None: clear) the process-wide engine."""
    global _engine
    with _engine_lock:
        _engine = engine
