"""What the serving cells share: the model and engine as the
configuration states them, the client loop around ``SlotEngine.submit``
and ``SlotEngine.step``, and the handling of each request's stream.

The loop is the client. It submits each request when it is due (an open
loop sends on its schedule whatever the engine is doing; a closed loop's
next request is due when the last one ends), steps the engine, and stamps
every token a step delivered with the host clock at that step's return.
"""
from __future__ import annotations

import gc
import heapq
import queue
import time
from typing import Callable, Dict, List, Optional

from .record import Request, Run
from .trace import Tracer

#: the flight recorder's ring: more ticks than any run makes
RECORDER_TICKS = 1 << 16


def model_config(config: Dict, max_len: int, training: bool = False):
    """The port's ``TransformerConfig`` for a configuration file."""
    import torch
    from tensorhive_tpu_torch.models.transformer import TransformerConfig

    settings = config["training"] if training else config["serving"]
    return TransformerConfig(
        vocab_size=config["vocab_size"], d_model=config["hidden_size"],
        n_heads=config["num_attention_heads"],
        n_layers=config["num_hidden_layers"],
        d_ff=config["intermediate_size"], max_seq_len=max_len,
        dtype=getattr(torch, settings["dtype"]),
        rope_theta=float(config["rope_theta"]),
        n_kv_heads=config["num_key_value_heads"],
        remat=training, remat_policy=settings.get("remat_policy", "block"))


def build_engine(context, params, model):
    """``SlotEngine`` with the configuration's serving settings and the
    cell's, as ``core/services/generation.py::build_engine`` builds it (that
    function takes only named presets), and a flight recorder sized for
    the run."""
    from tensorhive_tpu_torch.serving.engine import SlotEngine
    from tensorhive_tpu_torch.serving.flight_recorder import FlightRecorder

    settings = dict(context.spec.config["serving"])
    settings.update(context.spec.cell.get("engine", {}))
    recorder = FlightRecorder(capacity=RECORDER_TICKS)
    engine = SlotEngine(
        params, model, slots=settings["slots"], max_len=settings["max_len"],
        queue_depth=settings["queue_depth"], top_k=None, eos_token=None,
        max_new_tokens_cap=settings["max_new_tokens_cap"],
        max_concurrent_per_user=0, paged=True,
        page_size=settings["page_size"], kv_pages=settings["kv_pages"],
        kv_quant=settings["kv_quant"], prefix_cache=settings["prefix_cache"],
        prefix_min_tokens=settings["prefix_min_tokens"],
        prefill_chunk_tokens=settings["prefill_chunk_tokens"],
        speculative=settings["speculative"], host_kv_bytes=0,
        default_deadline_s=0.0, flight_recorder=recorder,
        device=context.device)
    return engine, recorder


class Source:
    """Where requests come from: ``due()`` the next due time (None when
    nothing more will come), ``pop(now)`` the requests due by ``now``,
    ``done(request, now)`` told when a request ends."""

    def __init__(self) -> None:
        self._heap: list = []
        self._order = 0

    def push(self, due: float, request: Request) -> None:
        heapq.heappush(self._heap, (due, self._order, request))
        self._order += 1

    def due(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def pop(self, now: float) -> List[Request]:
        out = []
        while self._heap and self._heap[0][0] <= now:
            out.append(heapq.heappop(self._heap)[2])
        return out

    def done(self, request: Request, now: float) -> None:
        pass


class Client:
    """The loop: submits, steps, stamps, and records each tick."""

    def __init__(self, engine, recorder, source: Source, run: Run,
                 tracer: Tracer) -> None:
        self.engine = engine
        self.recorder = recorder
        self.source = source
        self.run = run
        self.tracer = tracer
        self.live: List[Request] = []
        #: per tick: start, end, recorder index, contexts emitted, traced
        self.ticks: List[Dict] = []
        self.window_start: Optional[float] = None

    def submit(self, request: Request, now: float) -> None:
        from tensorhive_tpu_torch.serving import (
            EngineDrainingError, QueueFullError, RateLimitError)

        self.run.requests.append(request)
        self.run.lateness.append(now - request.due)
        try:
            with self.tracer.span("portbench.submit"):
                request.handle = self.engine.submit(
                    request.prompt, request.max_new, temperature=0.0)
        except (QueueFullError, RateLimitError, EngineDrainingError,
                ValueError) as error:
            request.outcome = "refused"
            self.run.errors.append(f"refused: {error}")
            return
        self.live.append(request)

    def tick(self, in_window: bool) -> None:
        started = time.perf_counter()
        if in_window and self.window_start is not None:
            self.tracer.before(started - self.window_start,
                               self.run.cell["_seconds"])
        recorder_index = self.recorder.recorded
        with self.tracer.span("portbench.step"):
            self.engine.step()
        now = time.perf_counter()
        contexts = self.drain(now)
        self.ticks.append({"start": started, "end": now,
                           "recorder": recorder_index,
                           "contexts": contexts,
                           "traced": self.tracer.session})
        self.tracer.after()

    def drain(self, now: float) -> List[int]:
        """Take every event the step delivered; returns the context (rows
        attended) of each token emitted."""
        from tensorhive_tpu_torch.serving.engine import DONE, ERROR, TOKEN

        contexts = []
        still = []
        for request in self.live:
            events = request.handle._events
            ended = False
            while True:
                try:
                    kind, payload = events.get_nowait()
                except queue.Empty:
                    break
                if kind == TOKEN:
                    contexts.append(request.prompt_len + len(request.tokens))
                    request.tokens.append(int(payload))
                    request.times.append(now)
                elif kind == DONE:
                    request.outcome = payload["outcome"]
                    ended = True
                elif kind == ERROR:
                    request.outcome = "error"
                    self.run.errors.append(f"request failed: {payload}")
                    ended = True
            if ended:
                self.source.done(request, now)
            else:
                still.append(request)
        self.live = still
        return contexts

    def loop(self, until: Callable[[float], bool],
             in_window: bool = False) -> None:
        """Submit what is due and step until ``until(now)``; idle waits
        sleep to the next due time."""
        while True:
            now = time.perf_counter()
            for request in self.source.pop(now):
                self.submit(request, now)
            if until(now):
                return
            if self.engine.has_work():
                self.tick(in_window)
                continue
            due = self.source.due()
            pause = 0.001 if due is None else min(max(due - now, 0.0), 0.01)
            time.sleep(pause)


def recorder_rows(client: Client, recorder) -> None:
    """Attach each tick's flight-recorder row (the ring outlasts the run)."""
    if not client.ticks:
        return
    first = client.ticks[0]["recorder"]
    rows = recorder.snapshot(last_n=recorder.recorded - first)
    by_tick = {row["tick"]: row for row in rows}
    for tick in client.ticks:
        tick["row"] = by_tick.get(tick["recorder"], {})


def release() -> None:
    """Return the memory of the state the caller dropped (the program's,
    before the reference runs)."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def memory_peak() -> int:
    import torch

    return (int(torch.cuda.max_memory_allocated())
            if torch.cuda.is_available() else 0)


def summary(run: Run) -> str:
    """One line on the window's load: requests due and their TTFT, the
    admission queue and busy slots by thirds of the window, the
    generator's lateness."""
    from .record import percentile

    due = run.window_requests()
    waits = [r.first - r.due for r in due if r.first is not None]
    thirds = []
    ticks = [t["row"] for t in run.ticks if t.get("row")]
    for part in range(3):
        rows = ticks[part * len(ticks) // 3:(part + 1) * len(ticks) // 3]
        if rows:
            thirds.append(
                f"{sum(r['queueDepth'] for r in rows) / len(rows):.1f}q/"
                f"{sum(r['slotsBusy'] for r in rows) / len(rows):.1f}s")
    late = max(run.lateness, default=0.0)
    return (f"{len(due)} due, {len(waits)} with a first token; ttft p50 "
            f"{percentile(waits, 50)!r} p90 {percentile(waits, 90)!r}; "
            f"queue/slots by thirds {' '.join(thirds)}; {len(ticks)} ticks; "
            f"latest send {late:.3f} s")

