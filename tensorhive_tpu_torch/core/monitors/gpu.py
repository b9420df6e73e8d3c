"""GPU card monitor — the counterpart of
``tensorhive_tpu/core/monitors/tpu.py``'s ``TpuMonitor``.

One probe round trip per host per tick (``probe.py``), mapped onto the
cards of each host: a card's processes are the PIDs that hold its device
node open, its memory and utilization the driver's counters (or the
workload's drop files where the driver reports none). ``transports`` and
``infra`` are taken by duck type: ``transports.hostnames`` and
``run_on_all(command, hostnames=)``; ``infra.update_subtree``,
``record_probe_failure`` and ``host_leases`` — the control plane's
``TransportManager`` and ``InfrastructureManager`` have them.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional

from ...config import Config, HostConfig, get_config
from ...observability import get_registry
from .base import Monitor
from .probe import ProbeSample, collect_probe_samples, probe_command

log = logging.getLogger(__name__)

#: the lease state of a host that left the fleet (the control plane's)
LEASE_DEREGISTERED = "deregistered"

_CONSECUTIVE_FAILURES = get_registry().gauge(
    "tpuhive_probe_consecutive_failures",
    "Consecutive failed probe rounds per host (0 = healthy).",
    labels=("host",))


def chip_uid(hostname: str, index: int) -> str:
    """A card's id across the fleet (the JAX package's ``chip_uid``, with
    the device kind ``gpu``)."""
    return f"{hostname}:gpu:{index}"


class GpuMonitor(Monitor):
    key = "GPU"

    def __init__(self, config: Optional[Config] = None) -> None:
        self.config = config or get_config()
        self._command = probe_command()
        self._restricted_warned: set = set()

    def update(self, transports: Any, infra: Any) -> None:
        """Probe every host but those that push their own telemetry
        (``agent_hosts``) and write each one's ``GPU`` and ``WARNINGS``
        subtrees; a host whose probe failed keeps its last subtrees and
        counts one failed round."""
        skip = self.agent_hosts(infra)
        targets = [h for h in transports.hostnames if h not in skip]
        samples = collect_probe_samples(transports, self._command,
                                        hostnames=targets)
        for hostname, sample in samples.items():
            if sample is None:
                streak = infra.record_probe_failure(hostname)
                _CONSECUTIVE_FAILURES.labels(host=hostname).set(streak)
                continue
            _CONSECUTIVE_FAILURES.labels(host=hostname).set(0)
            if (sample.restricted > 0
                    and hostname not in self._restricted_warned):
                self._restricted_warned.add(hostname)
                log.warning(
                    "probe on %s runs unprivileged: %d processes were not "
                    "inspectable — card ownership may be incomplete; grant "
                    "passwordless sudo for the probe to fix this", hostname,
                    sample.restricted)
            infra.update_subtree(hostname, self.key, chip_subtree(
                hostname, sample, self.config.hosts.get(hostname)))
            infra.update_subtree(hostname, "WARNINGS",
                                 host_warnings(hostname, sample))

    def agent_hosts(self, infra: Any) -> set:
        """Hosts the fan-out skips: configured with ``agent = true`` or
        joined through the agent report path (lease source ``agent``, not
        deregistered)."""
        agents = {name for name, cfg in self.config.hosts.items()
                  if getattr(cfg, "agent", False)}
        for name, lease in infra.host_leases().items():
            if (lease["source"] == "agent"
                    and lease["state"] != LEASE_DEREGISTERED):
                agents.add(name)
        return agents


def host_warnings(hostname: str, sample: ProbeSample) -> list:
    """Per-host health warnings: a host with cards whose probe read no
    driver counters reports other workloads' utilization as idle, which
    must be said out loud."""
    warnings = []
    if sample.chips and sample.sysfs_status != "ok":
        warnings.append({
            "key": "driver_counters_absent",
            "message": (
                "no driver counters (NVML): utilization of "
                "non-cooperating workloads is invisible on this host — "
                "check the NVIDIA driver"),
        })
    return warnings


def chip_subtree(hostname: str, sample: ProbeSample,
                 host_cfg: Optional[HostConfig] = None
                 ) -> Dict[str, Dict[str, Any]]:
    """The per-host card subtree from one parsed probe sample (the pull
    path here, and an agent's push path alike)."""
    accel_type = host_cfg.accelerator_type if host_cfg else ""
    slice_name = host_cfg.slice_name if host_cfg else ""
    topology = (host_cfg.topology if host_cfg else "") or ""
    chips: Dict[str, Dict[str, Any]] = {}
    for chip in sample.chips:
        uid = chip_uid(hostname, chip.index)
        processes = [{"pid": pid,
                      "user": sample.procs.get(pid, {}).get("user", ""),
                      "command": sample.procs.get(pid, {}).get("cmd", "")}
                     for pid in chip.pids]
        used, total = chip.hbm_used_bytes, chip.hbm_total_bytes
        chips[uid] = {
            "uid": uid,
            "index": chip.index,
            "hostname": hostname,
            "name": f"{chip.name or accel_type or 'GPU'} {chip.index}",
            "accelerator_type": accel_type,
            "slice_name": slice_name,
            "topology": topology,
            "dev": chip.dev,
            "hbm_used_mib": _to_mib(used),
            "hbm_total_mib": _to_mib(total),
            "hbm_util_pct": _pct(used, total),
            "duty_cycle_pct": chip.duty_cycle_pct,
            "metrics_age_s": chip.metrics_age_s,
            "processes": processes,
        }
    return chips


def _to_mib(value_bytes: Optional[int]) -> Optional[int]:
    return None if value_bytes is None else int(value_bytes // 2**20)


def _pct(used: Optional[int], total: Optional[int]) -> Optional[float]:
    if used is None or not total:
        return None
    return round(100.0 * used / total, 1)
