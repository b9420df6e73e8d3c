"""Per-request serving ledger — a copy of
``tensorhive_tpu/observability/requests.py`` on a plain ``threading.Lock``
where JAX uses its lock witness.

Every ``SlotEngine.submit`` mints a ``request_id``, the engine stamps each
phase transition into a :class:`RequestRecord`, and completed records land
in a bounded, thread-safe ring:

* **The engine's lock is hot.** Ledger calls happen inside the scheduler
  loop (some under the engine lock), so every method is a handful of
  dict/deque operations behind one leaf lock; the ledger never calls back
  into the engine and never touches the device.
* **Bounded by construction.** Completed records live in a
  ``deque(maxlen=capacity)``; in-flight records are bounded by the
  engine's admission limits.
* **Phases are engine-clock durations, wall-clock anchors.** Durations
  come from the engine's (possibly fake) clock; one ``time.time()`` stamp
  taken at submit anchors them.
* **Rejections are requests too.** Queue-full and rate-limit rejections
  get a record with their outcome.
"""
from __future__ import annotations

import collections
import itertools
import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional


DEFAULT_CAPACITY = 256

#: terminal outcomes a record can carry (mirrors
#: ``tpuhive_generate_requests_total{outcome=...}``). ``failed`` is the
#: supervisor's fail-fast path (engine fault → terminal error chunk);
#: ``timeout`` is a per-request deadline expiring in queue, mid-prefill or
#: mid-decode (docs/ROBUSTNESS.md "Serving data plane").
OUTCOMES = ("completed", "cancelled", "failed", "timeout",
            "rejected_queue", "rejected_ratelimit")


@dataclass
class RequestRecord:
    """One generate request's lifecycle, phase by phase.

    Durations are milliseconds measured on the engine clock; ``None`` means
    the request never reached that phase (a queue-full rejection has no
    prefill, a cancel mid-queue has no TTFT).
    """

    request_id: str
    #: wall-clock submit stamp (unix seconds) — the anchor every span and
    #: log line correlates against
    submitted_ts: float
    prompt_tokens: int
    max_new_tokens: int
    temperature: float
    user_key: Optional[str] = None
    outcome: Optional[str] = None          # None while in flight
    slot: Optional[int] = None
    kv_pages: Optional[int] = None         # pages granted (paged engines)
    queue_ms: Optional[float] = None
    #: prompt tokens the prefix cache let prefill skip (None: prefix cache
    #: off or the engine predates it; 0: a full miss)
    cached_tokens: Optional[int] = None
    #: prefill chunks dispatched (None: legacy whole-prompt prefill path;
    #: 0: full-prefix hit, nothing to prefill)
    prefill_chunks: Optional[int] = None
    prefill_bucket: Optional[int] = None
    #: "hit" (bucket executable reused) or "miss" (compiled) — joins the
    #: ``tpuhive_decode_compile_total`` fingerprint story per request
    prefill_compile: Optional[str] = None
    prefill_ms: Optional[float] = None
    #: KV-page tiering (docs/SERVING.md "KV-page tiering"): pages promoted
    #: from the host store instead of recomputed (None: tier off; 0: tier
    #: on, no host hit) and the promotion DMA's wall share of TTFT — split
    #: OUT of prefill_ms so slow joins triage to copy bandwidth vs
    #: recompute honestly
    host_hit_pages: Optional[int] = None
    promote_ms: Optional[float] = None
    ttft_ms: Optional[float] = None
    decode_ms: Optional[float] = None      # first token -> last token
    total_ms: Optional[float] = None
    #: speculative decoding lane (docs/SERVING.md "Speculative decoding"):
    #: draft tokens proposed for this request / accepted by the batched
    #: verify (None: lane off or the request predates it; acceptance
    #: measures draft agreement per verify, emission may truncate shorter
    #: at EOS or the max_new budget)
    draft_tokens: Optional[int] = None
    accepted_tokens: Optional[int] = None
    #: tenant accounting (docs/OBSERVABILITY.md "Tenant accounting"):
    #: the TenantMeter's per-request resource-time integrals, finalized
    #: at request end (None: [accounting] off or the row predates it)
    device_seconds: Optional[float] = None
    kv_byte_seconds: Optional[float] = None
    tokens: int = 0
    finished_ts: Optional[float] = None
    #: raw inter-token gaps (ms); bounded by max_new_tokens <= the engine cap
    _gaps_ms: List[float] = field(default_factory=list, repr=False)

    def intertoken_p50_ms(self) -> Optional[float]:
        if not self._gaps_ms:
            return None
        return round(statistics.median(self._gaps_ms), 3)

    def to_dict(self) -> Dict:
        def ms(value: Optional[float]) -> Optional[float]:
            return None if value is None else round(value, 3)

        return {
            "requestId": self.request_id,
            "outcome": self.outcome,             # null while in flight
            "submittedTs": round(self.submitted_ts, 6),
            "finishedTs": (round(self.finished_ts, 6)
                           if self.finished_ts is not None else None),
            "promptTokens": self.prompt_tokens,
            "maxNewTokens": self.max_new_tokens,
            "temperature": self.temperature,
            "userKey": self.user_key,
            "slot": self.slot,
            "kvPages": self.kv_pages,
            "queueMs": ms(self.queue_ms),
            "cachedTokens": self.cached_tokens,
            "prefillChunks": self.prefill_chunks,
            "prefillBucket": self.prefill_bucket,
            "prefillCompile": self.prefill_compile,
            "prefillMs": ms(self.prefill_ms),
            "hostHitPages": self.host_hit_pages,
            "promoteMs": ms(self.promote_ms),
            "ttftMs": ms(self.ttft_ms),
            "decodeMs": ms(self.decode_ms),
            "totalMs": ms(self.total_ms),
            "draftTokens": self.draft_tokens,
            "acceptedTokens": self.accepted_tokens,
            "acceptanceRate": (round(self.accepted_tokens
                                     / self.draft_tokens, 4)
                               if self.draft_tokens else None),
            "deviceSeconds": (round(self.device_seconds, 6)
                              if self.device_seconds is not None else None),
            "kvByteSeconds": (round(self.kv_byte_seconds, 3)
                              if self.kv_byte_seconds is not None else None),
            "tokens": self.tokens,
            "intertokenP50Ms": self.intertoken_p50_ms(),
        }


class RequestLedger:
    """Thread-safe request lifecycle store: in-flight records by id, a
    bounded ring of finished ones, oldest evicted first."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._lock = threading.Lock()
        self._capacity = capacity
        self._finished: Deque[RequestRecord] = collections.deque(
            maxlen=capacity)
        self._inflight: Dict[str, RequestRecord] = {}
        self._ids = itertools.count(1)
        #: distinguishes engines/restarts within one process so ids never
        #: collide across ledger resets (tests build many engines)
        self._epoch = itertools.count(1)
        self._epoch_tag = next(self._epoch)

    @property
    def capacity(self) -> int:
        return self._capacity

    def set_capacity(self, capacity: int) -> None:
        """Re-bound the finished ring (config ``request_ledger_size``);
        retains the newest records that still fit."""
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        with self._lock:
            self._capacity = capacity
            self._finished = collections.deque(self._finished,
                                               maxlen=capacity)

    # -- lifecycle ---------------------------------------------------------
    def new_request_id(self) -> str:
        with self._lock:
            return f"g{self._epoch_tag:x}-{next(self._ids):08x}"

    def begin(self, request_id: str, *, prompt_tokens: int,
              max_new_tokens: int, temperature: float,
              user_key: Optional[str] = None,
              submitted_ts: Optional[float] = None) -> RequestRecord:
        record = RequestRecord(
            request_id=request_id,
            submitted_ts=(time.time() if submitted_ts is None
                          else submitted_ts),
            prompt_tokens=prompt_tokens,
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            user_key=user_key,
        )
        with self._lock:
            self._inflight[request_id] = record
        return record

    def get(self, request_id: str) -> Optional[RequestRecord]:
        """The record, in flight or finished (None once evicted)."""
        with self._lock:
            record = self._inflight.get(request_id)
            if record is not None:
                return record
            for finished in self._finished:
                if finished.request_id == request_id:
                    return finished
            return None

    def finish(self, record: RequestRecord, outcome: str,
               finished_ts: Optional[float] = None) -> None:
        """Move a record to the finished ring exactly once; later calls
        (e.g. a cancel racing completion) are ignored."""
        with self._lock:
            if record.outcome is not None:
                return
            record.outcome = outcome
            record.finished_ts = (time.time() if finished_ts is None
                                  else finished_ts)
            self._inflight.pop(record.request_id, None)
            self._finished.append(record)

    def discard(self, record: RequestRecord) -> None:
        """Drop an in-flight record without recording an outcome (used when
        submit-side validation fails after the record was minted)."""
        with self._lock:
            self._inflight.pop(record.request_id, None)

    # -- reading -----------------------------------------------------------
    def recent(self, limit: Optional[int] = None,
               outcome: Optional[str] = None,
               user: Optional[str] = None) -> List[Dict]:
        """Finished records, newest first; ``outcome=`` and ``user=``
        (exact ``userKey`` match) filters compose."""
        with self._lock:
            records = list(self._finished)
        records.reverse()
        if outcome is not None:
            records = [r for r in records if r.outcome == outcome]
        if user is not None:
            records = [r for r in records if r.user_key == user]
        if limit is not None and limit >= 0:
            records = records[:limit]
        return [record.to_dict() for record in records]

    def in_flight(self) -> List[Dict]:
        """Requests currently queued or running, oldest submit first."""
        with self._lock:
            records = sorted(self._inflight.values(),
                             key=lambda r: r.submitted_ts)
        return [record.to_dict() for record in records]

    def __len__(self) -> int:
        with self._lock:
            return len(self._finished)

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()
            self._inflight.clear()
            self._epoch_tag = next(self._epoch)


_ledger = RequestLedger()


def get_request_ledger() -> RequestLedger:
    """Process-wide request ledger."""
    return _ledger
