"""Node telemetry probe of GPU hosts: one remote round trip per host per
tick — the counterpart of ``tensorhive_tpu/core/monitors/probe.py``.

The probe runs on the managed host and prints one JSON line: the cards,
the processes holding them, their owners and commands, CPU jiffies,
memory, and per-card counters. The document is the JAX package's schema
version 1, so the subtrees the monitor builds and the dashboard reads keep
their keys::

    {"v": 1,
     "chips":   [{"index": 0, "dev": "/dev/nvidia0", "name": "NVIDIA H100",
                  "pids": [123, ...]}, ...],
     "procs":   {"123": {"user": "alice", "cmd": "python train.py"}, ...},
     "cpu":     {"total": <jiffies>, "idle": <jiffies>, "ncpu": 8},
     "mem":     {"total_kb": N, "avail_kb": N},
     "metrics": {"0": {"hbm_used_bytes": N, "hbm_total_bytes": N,
                       "duty_cycle_pct": F, "age_s": F}, ...},
     "sysfs_metrics": {"0": {"hbm_used_bytes": N, "hbm_total_bytes": N,
                             "duty_cycle_pct": F}, ...},
     "sysfs_status": "ok" | "absent", "restricted": N}

What the GPU probe puts there:

* ``chips`` — the cards the driver lists through NVML (``libnvidia-ml.so.1``
  loaded at run time; the few entry points used are declared in the
  probes), by NVML's index, each with its device node
  ``/dev/nvidia<minor number>`` and its ``name`` (an addition the JAX
  parser ignores). A container's ``/dev`` may hold other cards' nodes,
  which the driver does not list. Without NVML the cards are the
  ``/dev/nvidia<N>`` nodes in the order of N (``/dev/nvidiactl`` and
  ``/dev/nvidia-uvm`` are held by every CUDA process and name no card).
* holder PIDs — a ``/proc/*/fd`` scan for links to a card's node, as in
  JAX: a CUDA context holds its card's node open. NVML's compute-process
  PIDs are not used: in a container they are the host's PID namespace's
  and need not match ``/proc``.
* ``sysfs_metrics`` — the driver's counters, which see any workload:
  memory used and total and the utilization that stands for
  ``duty_cycle_pct``, from NVML. The key keeps its schema name;
  ``sysfs_status`` is "ok" when any counter was read, "absent" otherwise,
  which the monitor turns into a warning.
* ``metrics`` — the workload's drop files (``telemetry.py``,
  ``~/.tpuhive/metrics/*.json``), the fallback; stale files (>120 s) are
  flagged by ``age_s`` and ignored.

Two probes emit it: ``native/probe.cpp`` (built with ``g++`` at first use
by :func:`build_native_probe`, installed on hosts as
``PROBE_REMOTE_PATH``) and :data:`PYTHON_PROBE_SOURCE`, an inline Python
script run when the binary is absent. Both take the seams the tests use:
a device directory (``--dev-dir`` / ``TPUHIVE_DEV_DIR``) and the NVML
library to load (``--nvml-lib`` / ``TPUHIVE_NVML_LIB``; a test's is a
fake), besides JAX's ``--metrics-dir`` / ``TPUHIVE_METRICS_DIR``.
"""
from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from ...observability import get_registry, get_tracer
from ...ops.cuda_build import BUILD_DIR

log = logging.getLogger(__name__)

_ROUND_SECONDS = get_registry().histogram(
    "tpuhive_probe_round_seconds",
    "One probe round: fan-out to all hosts plus parsing.")
_ROUNDS_TOTAL = get_registry().counter(
    "tpuhive_probe_rounds_total", "Probe rounds executed.")
_PROBE_FAILURES = get_registry().counter(
    "tpuhive_probe_failures_total",
    "Per-host probe failures by reason (unreachable, unparseable).",
    labels=("host", "reason"))
_PROBE_HOSTS_OK = get_registry().gauge(
    "tpuhive_probe_hosts_ok",
    "Hosts whose last probe round produced a valid sample.")
_PROBE_LAST_ROUND_TS = get_registry().gauge(
    "tpuhive_probe_last_round_timestamp_seconds",
    "Unix time the last probe round completed.")

PROBE_VERSION = 1
#: stable marker present in every probe invocation (fake transports match it)
PROBE_MARKER = "tpuhive_probe"
#: where the native GPU probe is installed on managed hosts
PROBE_REMOTE_PATH = "$HOME/.tpuhive/bin/tpuhive-gpu-probe"
#: runtime metric drop files older than this are reported but flagged stale
METRICS_MAX_AGE_S = 120.0

NATIVE_SOURCE = Path(__file__).resolve().parents[2] / "native" / "probe.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra")
#: the linker's libraries, after the source (dlopen)
CXX_LIBS = ("-ldl",)


class TelemetryError(Exception):
    """A probe's output could not be read (the JAX package's
    ``TelemetryError``)."""


# The fallback probe: dependency-free Python 3.6+, one JSON line on stdout.
# Mirrors native/probe.cpp — change both together (schema v1).
PYTHON_PROBE_SOURCE = r"""
import ctypes, json, os, pwd, re, time
out = {"v": 1, "chips": [], "procs": {}, "cpu": {}, "mem": {}, "metrics": {},
       "sysfs_metrics": {}, "restricted": 0}
ddir = os.environ.get("TPUHIVE_DEV_DIR") or "/dev"
cards = []
class Memory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]
class Utilization(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]
P, U = ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)
try:
    nvml = ctypes.CDLL(os.environ.get("TPUHIVE_NVML_LIB") or "libnvidia-ml.so.1")
    for name, args in (
            ("nvmlInit_v2", []), ("nvmlShutdown", []),
            ("nvmlDeviceGetCount_v2", [U]),
            ("nvmlDeviceGetHandleByIndex_v2", [ctypes.c_uint, ctypes.POINTER(P)]),
            ("nvmlDeviceGetMinorNumber", [P, U]),
            ("nvmlDeviceGetName", [P, ctypes.c_char_p, ctypes.c_uint]),
            ("nvmlDeviceGetMemoryInfo", [P, ctypes.POINTER(Memory)]),
            ("nvmlDeviceGetUtilizationRates", [P, ctypes.POINTER(Utilization)])):
        getattr(nvml, name).argtypes = args
        getattr(nvml, name).restype = ctypes.c_int
    ready = nvml.nvmlInit_v2() == 0
except (OSError, AttributeError):
    ready = False
if ready:
    count = ctypes.c_uint(0)
    if nvml.nvmlDeviceGetCount_v2(ctypes.byref(count)) != 0:
        count.value = 0
    for i in range(count.value):
        device, minor = ctypes.c_void_p(), ctypes.c_uint(0)
        if (nvml.nvmlDeviceGetHandleByIndex_v2(i, ctypes.byref(device)) != 0
                or nvml.nvmlDeviceGetMinorNumber(device, ctypes.byref(minor)) != 0):
            continue
        card = {"index": i, "dev": os.path.join(ddir, "nvidia%d" % minor.value),
                "name": ""}
        buf = ctypes.create_string_buffer(96)
        if nvml.nvmlDeviceGetName(device, buf, 96) == 0:
            card["name"] = buf.value.decode(errors="replace")
        counters = {}
        mem, util = Memory(), Utilization()
        if nvml.nvmlDeviceGetMemoryInfo(device, ctypes.byref(mem)) == 0:
            counters["hbm_used_bytes"] = mem.used
            counters["hbm_total_bytes"] = mem.total
        if nvml.nvmlDeviceGetUtilizationRates(device, ctypes.byref(util)) == 0:
            counters["duty_cycle_pct"] = util.gpu
        if counters:
            out["sysfs_metrics"][str(i)] = counters
        cards.append(card)
    nvml.nvmlShutdown()
if not cards:
    try:
        names = [n for n in os.listdir(ddir) if re.match(r"nvidia[0-9]+$", n)]
    except OSError:
        names = []
    cards = [{"index": i, "dev": os.path.join(ddir, n), "name": ""}
             for i, n in enumerate(sorted(names, key=lambda n: int(n[6:])))]
dev_index = {os.path.realpath(c["dev"]): c["index"] for c in cards}
holders = {}
for pid in filter(str.isdigit, os.listdir("/proc")) if cards else ():
    fd_dir = "/proc/%s/fd" % pid
    try:
        fds = os.listdir(fd_dir)
    except PermissionError:
        out["restricted"] += 1
        continue
    except OSError:
        continue
    for fd in fds:
        try:
            target = os.readlink(os.path.join(fd_dir, fd))
        except OSError:
            continue
        if target in dev_index:
            holders.setdefault(dev_index[target], set()).add(int(pid))
for card in cards:
    card["pids"] = sorted(holders.get(card["index"], ()))
    out["chips"].append(card)
pids = set()
for chip in out["chips"]:
    pids.update(chip["pids"])
for pid in pids:
    try:
        with open("/proc/%d/cmdline" % pid, "rb") as fh:
            cmd = fh.read().replace(b"\0", b" ").decode(errors="replace").strip()
        uid = os.stat("/proc/%d" % pid).st_uid
        try:
            user = pwd.getpwuid(uid).pw_name
        except KeyError:
            user = str(uid)
        out["procs"][str(pid)] = {"user": user, "cmd": cmd}
    except OSError:
        continue
try:
    with open("/proc/stat") as fh:
        parts = fh.readline().split()[1:]
    vals = [int(x) for x in parts]
    out["cpu"] = {"total": sum(vals), "idle": vals[3] + (vals[4] if len(vals) > 4 else 0),
                  "ncpu": os.cpu_count() or 1}
except (OSError, IndexError, ValueError):
    pass
try:
    info = {}
    with open("/proc/meminfo") as fh:
        for line in fh:
            key, _, rest = line.partition(":")
            info[key] = int(rest.split()[0])
    out["mem"] = {"total_kb": info.get("MemTotal", 0),
                  "avail_kb": info.get("MemAvailable", info.get("MemFree", 0))}
except OSError:
    pass
mdir = os.environ.get("TPUHIVE_METRICS_DIR") or os.path.expanduser("~/.tpuhive/metrics")
now = time.time()
try:
    files = sorted(os.listdir(mdir))
except OSError:
    files = []
for name in files:
    if not name.endswith(".json"):
        continue
    path = os.path.join(mdir, name)
    try:
        age = now - os.stat(path).st_mtime
        with open(path) as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        continue
    if not isinstance(data, dict):
        continue
    for chip_index, metrics in data.items():
        if isinstance(metrics, dict):
            merged = dict(metrics)
            merged["age_s"] = round(max(age, 0.0), 1)
            out["metrics"][str(chip_index)] = merged
out["sysfs_status"] = "ok" if out["sysfs_metrics"] else "absent"
print(json.dumps(out, separators=(",", ":")))
""".strip()


def native_probe_path() -> Path:
    """Where the native probe built from this checkout's source lives
    (named by a hash of the source and flags: a changed source builds
    anew)."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + CXX_LIBS).encode())
    digest.update(NATIVE_SOURCE.read_bytes())
    return BUILD_DIR / f"tpuhive-gpu-probe-{digest.hexdigest()[:16]}"


def build_native_probe() -> Path:
    """The native probe's binary, compiled with ``g++`` (``CXX`` if set)
    when this source has not been built yet; raises with the compiler's
    output when the build fails."""
    target = native_probe_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    command = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(partial),
               str(NATIVE_SOURCE), *CXX_LIBS]
    proc = subprocess.run(command, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native probe build failed ({' '.join(command)}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(partial, target)
    return target


def probe_command() -> str:
    """Shell command: the native probe if installed — under passwordless
    sudo when available, since ``/proc/<pid>/fd`` of other users'
    processes is unreadable without it — else the inline Python probe.
    The metrics directory travels as a flag (default sudoers reject
    ``sudo VAR=... cmd``); the base64 wrapper survives any quoting the
    transport applies."""
    encoded = base64.b64encode(PYTHON_PROBE_SOURCE.encode()).decode()
    fallback = (
        f'python3 -c "import base64 as b;exec(b.b64decode(\'{encoded}\'))"'
    )
    sudo_flags = '--metrics-dir "$HOME/.tpuhive/metrics"'
    return (
        f"sudo -n {PROBE_REMOTE_PATH} {sudo_flags} 2>/dev/null "
        f"|| {PROBE_REMOTE_PATH} 2>/dev/null "
        f"|| {fallback}  # {PROBE_MARKER}"
    )


@dataclass
class ChipSample:
    index: int
    dev: str = ""
    #: the card's name from the driver ("" where the probe read none)
    name: str = ""
    pids: List[int] = field(default_factory=list)
    hbm_used_bytes: Optional[int] = None
    hbm_total_bytes: Optional[int] = None
    duty_cycle_pct: Optional[float] = None
    metrics_age_s: Optional[float] = None
    #: where the utilization numbers came from: "sysfs" (the driver's
    #: counters — any workload), "dropfile" (self-reported telemetry), or
    #: None
    metrics_source: Optional[str] = None


@dataclass
class ProbeSample:
    """Parsed, validated probe output for one host."""

    chips: List[ChipSample] = field(default_factory=list)
    procs: Dict[int, Dict[str, str]] = field(default_factory=dict)
    cpu_total: Optional[int] = None
    cpu_idle: Optional[int] = None
    ncpu: int = 1
    mem_total_kb: int = 0
    mem_avail_kb: int = 0
    #: processes whose /proc/<pid>/fd was unreadable (probe unprivileged)
    restricted: int = 0
    #: "ok" when the probe read the driver's per-card counters, "absent"
    #: when it read none (utilization of other workloads is then blind)
    sysfs_status: str = "absent"


def parse_probe_output(text: str) -> ProbeSample:
    """Parse one probe JSON line (the last line that looks like JSON)."""
    line = _last_json_line(text)
    try:
        doc = json.loads(line)
    except json.JSONDecodeError as exc:
        raise TelemetryError(
            f"probe output is not valid JSON: {exc}: {line[:200]!r}")
    if not isinstance(doc, dict) or doc.get("v") != PROBE_VERSION:
        raise TelemetryError("unsupported probe schema: "
                             f"{doc if isinstance(doc, dict) else type(doc)}")
    try:
        return _build_sample(doc)
    except (KeyError, ValueError, TypeError) as exc:
        raise TelemetryError(
            f"malformed probe document: {exc!r}: {line[:200]!r}")


def _build_sample(doc: Dict[str, Any]) -> ProbeSample:
    sample = ProbeSample()
    metrics = doc.get("metrics") or {}
    sysfs = doc.get("sysfs_metrics") or {}
    for raw in doc.get("chips") or []:
        chip = ChipSample(index=int(raw["index"]), dev=str(raw.get("dev", "")),
                          name=str(raw.get("name", "")),
                          pids=[int(p) for p in raw.get("pids", [])])
        # utilization merges per field, the driver's counters over drop
        # files: a counter that is missing keeps the drop file's value
        chip_metrics = metrics.get(str(chip.index))
        if isinstance(chip_metrics, dict):
            age = chip_metrics.get("age_s")
            chip.metrics_age_s = float(age) if age is not None else None
            if (chip.metrics_age_s is None
                    or chip.metrics_age_s <= METRICS_MAX_AGE_S):
                chip.hbm_used_bytes = _opt_int(
                    chip_metrics.get("hbm_used_bytes"))
                chip.hbm_total_bytes = _opt_int(
                    chip_metrics.get("hbm_total_bytes"))
                chip.duty_cycle_pct = _opt_float(
                    chip_metrics.get("duty_cycle_pct"))
                if chip_metrics:
                    chip.metrics_source = "dropfile"
        chip_sysfs = sysfs.get(str(chip.index))
        if isinstance(chip_sysfs, dict) and chip_sysfs:
            for name, convert in (("hbm_used_bytes", _opt_int),
                                  ("hbm_total_bytes", _opt_int),
                                  ("duty_cycle_pct", _opt_float)):
                value = convert(chip_sysfs.get(name))
                if value is not None:
                    setattr(chip, name, value)
            chip.metrics_source = "sysfs"
        sample.chips.append(chip)

    for pid, info in (doc.get("procs") or {}).items():
        if isinstance(info, dict):
            sample.procs[int(pid)] = {"user": str(info.get("user", "")),
                                      "cmd": str(info.get("cmd", ""))}

    cpu = doc.get("cpu") or {}
    if "total" in cpu and "idle" in cpu:
        sample.cpu_total = int(cpu["total"])
        sample.cpu_idle = int(cpu["idle"])
        sample.ncpu = int(cpu.get("ncpu", 1) or 1)
    mem = doc.get("mem") or {}
    sample.mem_total_kb = int(mem.get("total_kb", 0) or 0)
    sample.mem_avail_kb = int(mem.get("avail_kb", 0) or 0)
    sample.restricted = int(doc.get("restricted", 0) or 0)
    sample.sysfs_status = str(
        doc.get("sysfs_status") or ("ok" if sysfs else "absent"))
    return sample


def collect_probe_samples(
    transports: Any, command: Optional[str] = None,
    hostnames: Optional[List[str]] = None,
) -> Dict[str, Optional[ProbeSample]]:
    """Fan the probe out to the hosts (``hostnames``, None = every managed
    host) through ``transports.run_on_all`` and parse the replies; a host
    that fails (unreachable or unparseable) maps to None."""
    samples: Dict[str, Optional[ProbeSample]] = {}
    started = time.perf_counter()
    with get_tracer().span("probe.collect", kind="probe") as span:
        for hostname, result in transports.run_on_all(
                command or probe_command(), hostnames=hostnames).items():
            if not result.ok:
                log.warning("probe failed on %s: %s", hostname,
                            result.stderr.strip()
                            or f"exit {result.exit_code}")
                _PROBE_FAILURES.labels(host=hostname,
                                       reason="unreachable").inc()
                samples[hostname] = None
                continue
            try:
                samples[hostname] = parse_probe_output(result.stdout)
            except TelemetryError as exc:
                log.warning("unparseable probe output from %s: %s", hostname,
                            exc)
                _PROBE_FAILURES.labels(host=hostname,
                                       reason="unparseable").inc()
                samples[hostname] = None
        healthy = sum(1 for sample in samples.values() if sample is not None)
        span.attrs["hosts"] = str(len(samples))
        span.attrs["ok"] = str(healthy)
        if healthy < len(samples):
            span.status = "error"
    _ROUND_SECONDS.observe(time.perf_counter() - started)
    _ROUNDS_TOTAL.inc()
    _PROBE_HOSTS_OK.set(healthy)
    _PROBE_LAST_ROUND_TS.set(time.time())
    return samples


def _last_json_line(text: str) -> str:
    """Login shells may print before the probe's line: the last line that
    looks like JSON."""
    for line in reversed(text.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return line
    raise TelemetryError(f"no JSON object in probe output: {text[:200]!r}")


def _opt_int(value: Any) -> Optional[int]:
    return None if value is None else int(value)


def _opt_float(value: Any) -> Optional[float]:
    return None if value is None else float(value)
