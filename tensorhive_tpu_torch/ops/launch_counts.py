"""Every kernel launch counter of the port's ops, in one list.

A wrapper counts its launches in module-level dicts (``launches``,
``launch_heads``) and registers each here at import. A launch recorded into
a CUDA graph runs at each replay and not at the capture:
``serving/step_graph.py`` takes back what a capture counted and adds it
again at every replay, for each counter of ``COUNTERS``, so the counters
count kernels that ran. A counter left out of this list would count a
graphed step once and its replays never.
"""
from __future__ import annotations

from typing import Dict, List

#: the registered counters, each a dict of launches by key
COUNTERS: List[Dict] = []


def register(*counters: Dict) -> None:
    """Add a wrapper's counters (the dicts themselves, updated in place)."""
    COUNTERS.extend(counters)
