"""Stoppable service threads — a copy of ``StoppableThread`` from
``tensorhive_tpu/utils/threading.py`` (the port imports nothing of the JAX
package). The loop runs ``do_run()`` until ``shutdown()``, and sleeping
goes through an :class:`threading.Event`, so ``shutdown()`` interrupts a
sleep at once instead of waiting out the interval."""
from __future__ import annotations

import threading
from typing import Optional


class StoppableThread(threading.Thread):
    """Thread running ``do_run()`` repeatedly until ``shutdown()`` is
    called."""

    def __init__(self, name: Optional[str] = None) -> None:
        super().__init__(name=name, daemon=True)
        self._stop_event = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    def run(self) -> None:  # pragma: no cover - exercised via services tests
        while not self._stop_event.is_set():
            self.do_run()

    def do_run(self) -> None:
        raise NotImplementedError

    def shutdown(self) -> None:
        self._stop_event.set()

    @property
    def stopped(self) -> bool:
        return self._stop_event.is_set()

    def wait(self, seconds: float) -> bool:
        """Sleep up to ``seconds``; returns True if shutdown was requested."""
        return self._stop_event.wait(seconds)
