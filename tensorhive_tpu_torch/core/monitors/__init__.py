"""Host telemetry of GPU hosts — the counterpart of
``tensorhive_tpu/core/monitors/``'s libtpu-specific half: the schema-v1
probe (``probe.py``, native binary ``native/probe.cpp`` and an inline
Python fallback) and :class:`GpuMonitor` in place of ``TpuMonitor``."""
from .base import Monitor
from .gpu import GpuMonitor

__all__ = ["GpuMonitor", "Monitor"]
