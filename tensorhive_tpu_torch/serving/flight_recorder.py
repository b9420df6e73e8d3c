"""Serving flight recorder: a per-tick ring plus crash dumps on fatal — a
copy of ``tensorhive_tpu/serving/flight_recorder.py`` (numpy only).

* :class:`FlightRecorder` — a bounded ring the SlotEngine stamps once per
  ``step()``: tick duration, per-phase work counts (admitted / prefill
  chunks / decode slots), slots busy, free KV pages, queue depth, kernel
  libraries built or loaded, fault-plan injections and host-tier copies.
  The port adds the tick's start on the wall clock (``start_ts``, the clock
  of ``torch.profiler``'s records) and the seconds of its phases on the
  engine's clock (``PHASES``: admission, the prefill chunks, the decode
  step's dispatch, its wait for the emitted tokens and the applying of
  them), which tile the tick in that order after the host tier's lane.
  Preallocated numpy columns, one writer (the pump thread), no locks
  beyond an index bump; pure host bookkeeping.
* :func:`write_crash_dump` — on a fatal classification the supervisor
  snapshots the last ticks, the in-flight ledger rows and the firing alerts
  into a JSON file under ``{config_dir}/flightrec/`` *before* failing the
  in-flight requests, so the dump shows what was running. Old dumps are
  pruned past ``flightrec_dumps``. The port has no alert engine: its
  supervisor writes ``firingAlerts`` empty.
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import re
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

DUMP_SCHEMA_VERSION = 1

#: ring columns in storage order; ``snapshot()`` emits them camelCased
FIELDS = (
    "duration_s",
    "admitted",
    "prefill_chunks",
    "decode_slots",
    "slots_busy",
    "queue_depth",
    "pages_free",
    "compiles",
    "faults",
    "host_demotions",
    "host_promotions",
)

#: the tick's phases, in the order they tile it (float columns, seconds)
PHASES = ("admit_s", "prefill_s", "dispatch_s", "wait_s", "apply_s")

_CAMEL = {
    "duration_s": "durationS",
    "prefill_chunks": "prefillChunks",
    "decode_slots": "decodeSlots",
    "slots_busy": "slotsBusy",
    "queue_depth": "queueDepth",
    "pages_free": "pagesFree",
    "host_demotions": "hostDemotions",
    "host_promotions": "hostPromotions",
    "start_ts": "startTs",
    "admit_s": "admitS",
    "prefill_s": "prefillS",
    "dispatch_s": "dispatchS",
    "wait_s": "waitS",
    "apply_s": "applyS",
}

_DUMP_NAME_RE = re.compile(r"^crash-\d{8}T\d{6}-\d+(-\d{3})?\.json$")

#: per-process dump sequence: two fatals inside the same wall-clock second
#: (a crash loop chewing its restart budget) must not overwrite each other
_dump_seq = itertools.count()


class TickMarks:
    """The phase boundaries of one recorded tick, each one sample of the
    engine's clock: the sample that ends a phase begins the next, so the
    phases tile the tick. ``admit`` is the tick's start unless the host
    tier's lane ran first; a boundary left None (its phase did not run, as
    the speculative lane's dispatch and wait) makes that phase 0."""

    __slots__ = ("admit", "prefill", "dispatch", "wait", "apply", "applied")

    def __init__(self, started: float) -> None:
        self.admit: Optional[float] = started
        self.prefill: Optional[float] = None
        self.dispatch: Optional[float] = None
        self.wait: Optional[float] = None
        self.apply: Optional[float] = None
        self.applied: Optional[float] = None

    def phases(self) -> Dict[str, float]:
        """``FlightRecorder.record``'s phase keywords."""
        marks = (self.admit, self.prefill, self.dispatch, self.wait,
                 self.apply, self.applied)
        return {name: (end - begin if begin is not None and end is not None
                       else 0.0)
                for name, begin, end in zip(PHASES, marks, marks[1:])}


class FlightRecorder:
    """Bounded per-tick ring over preallocated numpy columns. The single
    pump-thread writer appends with a plain index bump; readers take
    consistent-enough snapshots (a torn in-progress row is acceptable —
    this is a black box, not a ledger)."""

    def __init__(self, capacity: int = 512) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ts = np.zeros(self.capacity, dtype=np.float64)
        self._duration = np.zeros(self.capacity, dtype=np.float64)
        self._counts = np.zeros((len(FIELDS) - 1, self.capacity),
                                dtype=np.int64)
        self._start = np.zeros(self.capacity, dtype=np.float64)
        self._phases = np.zeros((len(PHASES), self.capacity),
                                dtype=np.float64)
        self._idx = 0       # monotone tick counter; ring slot = idx % cap

    def record(self, *, duration_s: float, admitted: int = 0,
               prefill_chunks: int = 0, decode_slots: int = 0,
               slots_busy: int = 0, queue_depth: int = 0,
               pages_free: int = 0, compiles: int = 0,
               faults: int = 0, host_demotions: int = 0,
               host_promotions: int = 0,
               ts: Optional[float] = None,
               start_ts: Optional[float] = None, admit_s: float = 0.0,
               prefill_s: float = 0.0, dispatch_s: float = 0.0,
               wait_s: float = 0.0, apply_s: float = 0.0) -> None:
        """Stamp one tick. Hot path: column writes + one index bump.
        ``start_ts`` defaults to ``ts`` less the duration."""
        slot = self._idx % self.capacity
        stamp = time.time() if ts is None else ts
        self._ts[slot] = stamp
        self._duration[slot] = duration_s
        self._start[slot] = (stamp - duration_s if start_ts is None
                             else start_ts)
        phases = self._phases
        phases[0, slot] = admit_s
        phases[1, slot] = prefill_s
        phases[2, slot] = dispatch_s
        phases[3, slot] = wait_s
        phases[4, slot] = apply_s
        col = self._counts
        col[0, slot] = admitted
        col[1, slot] = prefill_chunks
        col[2, slot] = decode_slots
        col[3, slot] = slots_busy
        col[4, slot] = queue_depth
        col[5, slot] = pages_free
        col[6, slot] = compiles
        col[7, slot] = faults
        col[8, slot] = host_demotions
        col[9, slot] = host_promotions
        self._idx += 1

    @property
    def recorded(self) -> int:
        """Total ticks ever recorded (not capped at capacity)."""
        return self._idx

    def __len__(self) -> int:
        return min(self._idx, self.capacity)

    def snapshot(self, last_n: Optional[int] = None) -> List[Dict]:
        """Last ``last_n`` ticks (default: all retained), oldest first,
        as JSON-ready dicts."""
        count = len(self)
        if last_n is not None:
            count = min(count, max(int(last_n), 0))
        end = self._idx
        rows: List[Dict] = []
        for tick in range(end - count, end):
            slot = tick % self.capacity
            row = {
                "tick": tick,
                "ts": round(float(self._ts[slot]), 6),
                "durationS": round(float(self._duration[slot]), 6),
            }
            for offset, name in enumerate(FIELDS[1:]):
                row[_CAMEL.get(name, name)] = int(self._counts[offset, slot])
            row["startTs"] = round(float(self._start[slot]), 6)
            for offset, name in enumerate(PHASES):
                row[_CAMEL[name]] = round(float(self._phases[offset, slot]),
                                          6)
            rows.append(row)
        return rows

    def clear(self) -> None:
        self._idx = 0
        self._ts.fill(0.0)
        self._duration.fill(0.0)
        self._counts.fill(0)
        self._start.fill(0.0)
        self._phases.fill(0.0)


# -- crash dumps --------------------------------------------------------------

def write_crash_dump(directory: str, *, reason: str,
                     recorder: Optional[FlightRecorder],
                     inflight: Sequence[Dict] = (),
                     alerts: Optional[Sequence] = (),
                     max_dumps: int = 8,
                     now: Optional[float] = None) -> str:
    """Snapshot the recorder ring + in-flight ledger rows + firing alerts
    into ``{directory}/crash-<utc>-<pid>.json`` and prune the oldest
    dumps past ``max_dumps``. Returns the written path. ``alerts`` None
    (no alert engine in the process) leaves ``firingAlerts`` out of the
    dump. Callers (the supervisor's fail-fast path) must treat failures as
    best-effort — never let the post-mortem block the teardown."""
    if now is None:
        now = time.time()
    os.makedirs(directory, exist_ok=True)
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(now))
    # fixed-width sequence keeps lexical order == write order within the
    # same second, so prune/list newest-first stay correct
    seq = next(_dump_seq) % 1000
    path = os.path.join(
        directory, f"crash-{stamp}-{os.getpid()}-{seq:03d}.json")
    dump = {
        "schemaVersion": DUMP_SCHEMA_VERSION,
        "writtenTs": round(now, 3),
        "reason": str(reason),
        "ticks": recorder.snapshot() if recorder is not None else [],
        "ticksRecorded": recorder.recorded if recorder is not None else 0,
        "inFlight": list(inflight),
    }
    if alerts is not None:
        dump["firingAlerts"] = list(alerts)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as handle:
        json.dump(dump, handle, indent=1)
    os.replace(tmp, path)
    _prune_dumps(directory, max_dumps)
    return path


def _prune_dumps(directory: str, max_dumps: int) -> None:
    dumps = sorted(name for name in os.listdir(directory)
                   if _DUMP_NAME_RE.match(name))
    for name in dumps[:max(len(dumps) - max(int(max_dumps), 1), 0)]:
        try:
            os.remove(os.path.join(directory, name))
        except OSError:     # pragma: no cover - racing prune is fine
            log.warning("flightrec: could not prune %s", name)


def list_crash_dumps(directory: str) -> List[Dict]:
    """Summaries (newest first) of the dumps on disk."""
    if not os.path.isdir(directory):
        return []
    summaries: List[Dict] = []
    for name in sorted(os.listdir(directory), reverse=True):
        if not _DUMP_NAME_RE.match(name):
            continue
        path = os.path.join(directory, name)
        try:
            with open(path, "r", encoding="utf-8") as handle:
                dump = json.load(handle)
        except (OSError, ValueError):
            log.warning("flightrec: unreadable dump %s", name)
            continue
        summaries.append({
            "file": name,
            "writtenTs": dump.get("writtenTs"),
            "reason": dump.get("reason"),
            "ticks": len(dump.get("ticks", [])),
            "inFlight": len(dump.get("inFlight", [])),
            "firingAlerts": len(dump.get("firingAlerts", [])),
        })
    return summaries


def load_crash_dump(directory: str, name: str) -> Optional[Dict]:
    """Load one dump by filename; the strict name pattern doubles as
    path-traversal validation. None when missing or unreadable."""
    if not _DUMP_NAME_RE.match(name):
        return None
    path = os.path.join(directory, name)
    try:
        with open(path, "r", encoding="utf-8") as handle:
            return json.load(handle)
    except (OSError, ValueError):
        return None
