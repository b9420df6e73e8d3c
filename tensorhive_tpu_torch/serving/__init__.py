"""Serving subsystem of the port: continuous batching over the paged decode
path. A copy of ``tensorhive_tpu/serving/__init__.py``'s admission errors,
``CheckpointLoadError``, the process-wide engine slot and the supervisor's
serving state (the port imports nothing of the JAX package).

The process-wide engine is set in one place (``GenerationService`` at boot,
or whoever builds an engine) and read by whoever serves traffic;
``get_engine`` never constructs.
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


class CheckpointLoadError(Exception):
    """A configured ``checkpoint_path`` could not be served (missing,
    unreadable, or params shaped for another model config).
    ``GenerationService`` catches it at boot, leaves the engine unpublished
    and records the reason, instead of crashing or serving init params."""


__all__ = [
    "AdmissionError",
    "CheckpointLoadError",
    "EngineDrainingError",
    "QueueFullError",
    "RateLimitError",
    "get_engine",
    "get_serving_state",
    "get_unavailable_reason",
    "set_engine",
    "set_unavailable_reason",
    "update_serving_state",
]

_engine: Optional["SlotEngine"] = None
_unavailable_reason: Optional[str] = None
_engine_lock = threading.Lock()

#: supervisor lifecycle state, published by GenerationService
_serving_state = {
    #: a GenerationService supervisor owns this process's serving plane
    "supervisor_active": False,
    #: the restart budget was exhausted inside the window: the breaker is
    #: open until a cooldown-gated rebuild succeeds
    "crash_loop": False,
    #: successful engine rebuilds since the supervisor started
    "restarts": 0,
    #: Retry-After hint while the plane is down (seconds); None = default
    "retry_after_s": None,
}


def get_serving_state() -> dict:
    """Snapshot of the supervisor lifecycle state (a copy)."""
    with _engine_lock:
        return dict(_serving_state)


def update_serving_state(**updates) -> None:
    """Merge supervisor lifecycle updates (unknown keys are refused: the
    state is a contract between the supervisor and its readers)."""
    with _engine_lock:
        for key, value in updates.items():
            if key not in _serving_state:
                raise KeyError(f"unknown serving state key {key!r}")
            _serving_state[key] = value


def get_engine() -> Optional["SlotEngine"]:
    """The process-wide serving engine, or None when serving is off."""
    with _engine_lock:
        return _engine


def set_engine(engine: Optional["SlotEngine"]) -> None:
    """Install (or with None: clear) the process-wide engine. Installing an
    engine clears any recorded unavailability reason and the crash-loop
    flag: a published engine is the recovery signal."""
    global _engine, _unavailable_reason
    with _engine_lock:
        _engine = engine
        if engine is not None:
            _unavailable_reason = None
            _serving_state["crash_loop"] = False
            _serving_state["retry_after_s"] = None


def get_unavailable_reason() -> Optional[str]:
    """Why serving is down beyond 'not enabled' (a checkpoint that cannot be
    served, a crash loop)."""
    with _engine_lock:
        return _unavailable_reason


def set_unavailable_reason(reason: Optional[str]) -> None:
    global _unavailable_reason
    with _engine_lock:
        _unavailable_reason = reason
