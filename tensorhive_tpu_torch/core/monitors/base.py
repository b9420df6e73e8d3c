"""Monitor strategy interface — a copy of
``tensorhive_tpu/core/monitors/base.py``: ``update(transports, infra)`` is
run against every host each monitoring tick. ``transports`` and ``infra``
are taken by duck type (the control plane's ``TransportManager`` and
``InfrastructureManager``, or anything with their methods)."""
from __future__ import annotations

from typing import Any


class Monitor:
    """One telemetry dimension polled per tick."""

    #: subtree key this monitor owns inside each node's infra dict
    key: str = ""

    def update(self, transports: Any, infra: Any) -> None:
        """Poll all reachable hosts and write per-host subtrees into
        ``infra``. Must isolate per-host failures: one unreachable host may
        not prevent the others from updating."""
        raise NotImplementedError
