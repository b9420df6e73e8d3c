"""The serving daemon of the port — the counterpart of
``tensorhive_tpu/core/services/generation.py``: ``GenerationService``
(the pump thread and its supervisor), checkpoint loading, the flight
recorder's factory and ``build_engine``.

The daemon is thin: scheduling and batching live in
:mod:`tensorhive_tpu_torch.serving.engine`; the daemon builds the engine,
publishes it with ``serving.set_engine`` and drives ``engine.pump`` every
tick, inside 90% of ``interval_s`` so a saturated engine keeps a ~90% duty
cycle and ``shutdown()`` never waits on a long generation. On the card the
pump thread first makes the engine's device its current device, so the
kernels it launches and the events it records run on the same stream as
on the thread that built the engine.

Boot-time failure: a configured checkpoint that cannot be served (missing,
unreadable, shaped for another preset) leaves the daemon up with no engine
and the reason published (``serving.get_unavailable_reason``) — neither a
crash nor random weights in place of the requested ones.

Run-time failure (the supervisor): a pump tick that raises is classified
transient or fatal by ``serving/faults.py::classify_failure`` (fatal by
default). Transient failures retry the tick against the same engine with
bounded exponential backoff; a fatal one fails fast — a crash dump of the
flight recorder's ring and the in-flight ledger rows first, then every
in-flight stream ends with an error and an ``outcome=failed`` row — and the
engine is rebuilt under a restart budget. Exhausting the budget inside the
window trips a crash-loop breaker: the plane stays unpublished with the
reason, and one probe rebuild is allowed per cooldown. The budget, window
and cooldown run on an injectable ``clock``. ``shutdown()`` drains:
admission stops with a Retry-After, in-flight requests get
``drain_timeout_s`` to finish, stragglers are failed fast.

Beyond JAX, the dead engine's device state (weights, KV cache, draft lane)
is released before the rebuild: a client still holding a handle, or the
fault's traceback, keeps the engine object alive, and on a card a second
full engine beside the dead one may not fit.
"""
from __future__ import annotations

import dataclasses
import gc
import logging
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import torch

from ... import serving
from ...config import Config, GenerationConfig, get_config
from ...device import DeviceLike, resolve_device
from ...train import checkpoint_steps
from ...models.transformer import PRESETS, Params, TransformerConfig, \
    TransformerLM
from ...observability import get_registry, get_request_ledger
from ...observability.accounting import get_tenant_meter
from ...serving import CheckpointLoadError
from ...serving.engine import SlotEngine
from ...serving.faults import TRANSIENT, classify_failure
from ...serving.flight_recorder import FlightRecorder, write_crash_dump
from .base import Service

log = logging.getLogger(__name__)

_ENGINE_RESTARTS = get_registry().counter(
    "tpuhive_generate_engine_restarts_total",
    "Successful serving-engine rebuilds after a fatal data-plane failure "
    "(fresh cache + checkpoint reload).")
_STEP_FAILURES = get_registry().counter(
    "tpuhive_generate_step_failures_total",
    "Generation pump failures by classified kind: transient (tick retried "
    "against the same engine) or fatal (fail-fast + engine rebuild).",
    labels=("kind",))


class GenerationService(Service):
    """The pump thread and the supervisor of one serving engine.

    ``engine`` installs a prebuilt engine; ``engine_factory`` is what a
    rebuild calls (default: ``build_engine`` from ``config.generation`` on
    ``device``, where ``device`` None means ``cuda``). ``clock`` times the
    restart budget, its window and the breaker's cooldown."""

    def __init__(self, config: Optional[Config] = None,
                 engine: Optional[SlotEngine] = None,
                 engine_factory: Optional[Callable[[], SlotEngine]] = None,
                 device: DeviceLike = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        config = config or get_config()
        super().__init__(interval_s=config.generation.interval_s)
        self.generation_config = config.generation
        self._clock = clock
        #: where fatal failures leave flight-recorder crash dumps
        self._flightrec_dir = str(config.flightrec_dir)
        # ~90% duty cycle: pump inside the interval, leave a sliver for the
        # run loop's interruptible wait so shutdown is honoured promptly
        self._pump_budget_s = max(0.001, self.interval_s * 0.9)
        #: consecutive transient pump failures in the current incident
        self._transient_streak = 0
        #: clock stamps of rebuild attempts inside the sliding window
        self._restart_attempts: List[float] = []
        #: crash-loop breaker: no rebuilds before this clock stamp (None =
        #: closed)
        self._breaker_open_until: Optional[float] = None
        self._engine_factory = engine_factory
        # a fresh supervisor owns the plane from a clean slate
        serving.update_serving_state(supervisor_active=True, restarts=0,
                                     crash_loop=False, retry_after_s=None)
        self.engine: Optional[SlotEngine]
        if engine is not None:
            self.engine = engine
        else:
            if self._engine_factory is None:
                resolved = resolve_device(device)
                self._engine_factory = lambda: build_engine(
                    config.generation, device=resolved)
            try:
                self.engine = self._engine_factory()
            except CheckpointLoadError as exc:
                # the daemon stays up and the plane reports the reason;
                # nothing serves init params in place of a checkpoint
                log.error("generation serving disabled: %s", exc)
                serving.set_unavailable_reason(str(exc))
                self.engine = None
        if self.engine is not None:
            serving.set_engine(self.engine)
        #: the card the building thread's "cuda" meant: CUDA's current
        #: device and stream are per thread, and the pump thread launches
        #: on this card's default stream, as the building thread did
        self._cuda_index: Optional[int] = None
        if torch.cuda.is_available() and (
                self.engine is None or self.engine.device.type == "cuda"):
            self._cuda_index = (self.engine.device.index
                                if self.engine is not None
                                and self.engine.device.index is not None
                                else torch.cuda.current_device())

    def run(self) -> None:
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        super().run()

    def do_run(self) -> None:
        if self.engine is None:
            self._maybe_rebuild()
            return
        try:
            self.engine.pump(budget_s=self._pump_budget_s,
                             should_stop=lambda: self.stopped)
            self._transient_streak = 0
        except Exception as exc:    # noqa: BLE001 - the supervisor's seam
            self._handle_pump_failure(exc)

    # -- supervisor --------------------------------------------------------
    def _handle_pump_failure(self, exc: BaseException) -> None:
        """Classify one pump failure and act: transient -> bounded-backoff
        retry against the same engine; fatal (or the transient budget
        spent) -> fail fast every in-flight stream, then rebuild under the
        restart budget."""
        kind = classify_failure(exc)
        _STEP_FAILURES.labels(kind=kind).inc()
        generation = self.generation_config
        if (kind == TRANSIENT
                and self._transient_streak < generation.transient_retries):
            self._transient_streak += 1
            backoff = (generation.transient_backoff_s
                       * 2 ** (self._transient_streak - 1))
            log.warning(
                "generation pump transient failure "
                "(retry %d/%d after %.3fs): %s",
                self._transient_streak, generation.transient_retries,
                backoff, exc)
            if backoff > 0:
                self.wait(backoff)      # interruptible by shutdown
            return
        self._transient_streak = 0
        log.error("generation pump fatal failure (%s): failing fast and "
                  "rebuilding the engine", type(exc).__name__, exc_info=exc)
        self._fail_fast(exc)
        self._maybe_rebuild()

    def _fail_fast(self, exc: BaseException) -> None:
        """Unpublish the dead engine and finish every in-flight request with
        a terminal error and an ``outcome=failed`` row; then release its
        device state."""
        engine = self.engine
        self.engine = None
        if serving.get_engine() is engine:
            serving.set_engine(None)
        serving.set_unavailable_reason(
            f"serving engine failed ({type(exc).__name__}: {exc}); "
            "restart in progress")
        serving.update_serving_state(
            retry_after_s=max(1.0, 2 * self.interval_s))
        # the dump comes BEFORE the streams fail: its in-flight rows show
        # what was running when the fault hit
        self._write_crash_dump(engine, exc)
        failed = engine.fail_all_inflight(
            f"engine fault ({type(exc).__name__}: {exc}); the engine is "
            "restarting — retry the request")
        if failed:
            log.warning("failed fast %d in-flight generation request(s)",
                        failed)
        engine.release()

    def _write_crash_dump(self, engine: SlotEngine,
                          exc: BaseException) -> None:
        """Best-effort post-mortem: the flight recorder's ring and the
        in-flight ledger rows under ``{config_dir}/flightrec/``. A no-op
        without a recorder, and never allowed to block the fail-fast path.
        The port has no alert engine: the dump carries no
        ``firingAlerts``."""
        recorder = engine.flight_recorder
        if recorder is None:
            return
        try:
            path = write_crash_dump(
                self._flightrec_dir,
                reason=f"{type(exc).__name__}: {exc}",
                recorder=recorder,
                inflight=get_request_ledger().in_flight(),
                alerts=None,
                max_dumps=self.generation_config.flightrec_dumps)
            log.error("flight-recorder crash dump written: %s", path)
        except Exception:   # noqa: BLE001 - the post-mortem must never
            # out-crash the recovery
            log.exception("flight-recorder crash dump failed")

    def _maybe_rebuild(self) -> None:
        """Attempt an engine rebuild, at most ``restart_budget`` attempts
        per ``restart_window_s``. Exhausting it trips the crash-loop
        breaker: the plane stays unpublished with the reason until
        ``restart_cooldown_s`` elapses, then one probe era (a fresh budget)
        is allowed."""
        if self._engine_factory is None:
            return      # injected engine without a factory: nothing to do
        generation = self.generation_config
        now = self._clock()
        if self._breaker_open_until is not None:
            if now < self._breaker_open_until:
                return
            self._breaker_open_until = None
            self._restart_attempts.clear()      # half-open: fresh budget
        window = float(generation.restart_window_s)
        self._restart_attempts = [stamp for stamp in self._restart_attempts
                                  if now - stamp < window]
        if len(self._restart_attempts) >= generation.restart_budget:
            cooldown = float(generation.restart_cooldown_s)
            self._breaker_open_until = now + cooldown
            reason = (f"serving engine crash loop: "
                      f"{len(self._restart_attempts)} restarts in "
                      f"{window:g}s; breaker open, next rebuild attempt in "
                      f"{cooldown:g}s")
            log.error(reason)
            serving.set_unavailable_reason(reason)
            serving.update_serving_state(crash_loop=True,
                                         retry_after_s=cooldown)
            return
        self._restart_attempts.append(now)
        # what the dead engine left behind (reference cycles of requests,
        # handles and the engine) goes before a new engine allocates
        gc.collect()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.empty_cache()
        try:
            engine = self._engine_factory()
        except Exception as exc:    # noqa: BLE001 - rebuild failures are
            # the crash-loop signal, not a reason to kill the daemon
            log.error("generation engine rebuild failed: %s", exc,
                      exc_info=True)
            serving.set_unavailable_reason(
                f"engine rebuild failed ({type(exc).__name__}: {exc}); "
                "retrying")
            return
        self.engine = engine
        _ENGINE_RESTARTS.inc()
        restarts = serving.get_serving_state()["restarts"] + 1
        serving.update_serving_state(restarts=restarts)
        # publishing clears the reason, the crash-loop flag and the hint
        serving.set_engine(engine)
        log.info("generation engine restored (rebuild #%d)", restarts)

    def shutdown(self) -> None:
        """Stop through the drain: admission closes while in-flight
        requests get ``drain_timeout_s`` to finish; stragglers are failed
        fast with a terminal error, never left on a silent end."""
        engine = self.engine
        if engine is not None:
            engine.drain()
            deadline = time.monotonic() + max(
                0.0, float(self.generation_config.drain_timeout_s))
            while engine.has_work() and time.monotonic() < deadline:
                if self.is_alive():
                    # the pump thread is live and keeps draining
                    time.sleep(min(self.interval_s, 0.05))
                else:
                    # no pump running: drive the drain here
                    engine.pump(budget_s=self._pump_budget_s)
            if engine.has_work():
                failed = engine.fail_all_inflight(
                    "server shutting down: the drain timeout expired "
                    "before this request finished — retry")
                log.warning("drain timeout: failed fast %d in-flight "
                            "generation request(s)", failed)
        # unpublish before stopping the pump, so callers see no engine
        # instead of queueing onto a pump that will never run
        if engine is not None and serving.get_engine() is engine:
            serving.set_engine(None)
        serving.update_serving_state(supervisor_active=False,
                                     crash_loop=False, retry_after_s=None)
        super().shutdown()


# -- checkpoints ----------------------------------------------------------------

def _leaves_by_path(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` of a nested dict/list tree (``blocks[0].wq``)."""
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_leaves_by_path(
                tree[key], f"{prefix}.{key}" if prefix else str(key)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for index, item in enumerate(tree):
            out.update(_leaves_by_path(item, f"{prefix}[{index}]"))
        return out
    return {prefix: tree}


def _rebuild(tree, leaves: dict, prefix: str = ""):
    """``tree``'s structure with each leaf replaced from ``leaves``."""
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], leaves,
                              f"{prefix}.{key}" if prefix else str(key))
                for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(item, leaves, f"{prefix}[{index}]")
                for index, item in enumerate(tree)]
    return leaves[prefix]


def load_checkpoint_params(path: str, model_config: TransformerConfig,
                           device: DeviceLike = None) -> Tuple[int, Params]:
    """Load the newest ``train.save_checkpoint`` file under ``path`` for
    serving: ``(step, params)`` on ``device`` in the preset's dtypes
    (training writes f32 masters; serving weights are ``config.dtype``,
    norm scales f32).

    The file is mapped, not read, and its leaf names and shapes are checked
    against the preset's params — built on the ``meta`` device, which
    allocates nothing — before anything reaches the device. Raises
    :class:`~tensorhive_tpu_torch.serving.CheckpointLoadError`, naming the
    mismatches, whenever the checkpoint cannot be served as configured."""
    device = resolve_device(device)
    steps = checkpoint_steps(path)
    if not steps:
        raise CheckpointLoadError(f"no checkpoint steps under {path!r}")
    file = Path(path) / f"step_{steps[-1]:010d}.pt"
    try:
        saved = torch.load(file, map_location="cpu", weights_only=True,
                           mmap=True)
    except Exception as exc:
        raise CheckpointLoadError(
            f"cannot read checkpoint {path!r}: "
            f"{type(exc).__name__}: {exc}") from exc
    params = saved.get("params") if isinstance(saved, dict) else None
    if params is None:
        raise CheckpointLoadError(
            f"checkpoint {path!r} has no 'params' entry — not a "
            "train_loop checkpoint?")
    expected = TransformerLM.init(model_config, device="meta")
    got = _leaves_by_path(params)
    want = _leaves_by_path(expected)
    problems = []
    for missing in sorted(set(want) - set(got)):
        problems.append(f"{missing} missing")
    for extra in sorted(set(got) - set(want)):
        problems.append(f"{extra} unexpected")
    for key in sorted(set(want) & set(got)):
        shape = tuple(getattr(got[key], "shape", ()))
        if shape != tuple(want[key].shape):
            problems.append(f"{key} shape {shape} != expected "
                            f"{tuple(want[key].shape)}")
    if problems:
        raise CheckpointLoadError(
            f"checkpoint {path!r} does not fit preset params "
            f"({len(problems)} mismatches): " + "; ".join(problems[:6]))
    placed = {key: got[key].to(device=device, dtype=want[key].dtype)
              for key in want}
    return int(saved.get("step", steps[-1])), _rebuild(expected, placed)


def build_flight_recorder(
        generation: GenerationConfig) -> Optional[FlightRecorder]:
    """The engine's per-tick black box; None (an unrecorded ``step()``)
    when ``flight_recorder`` is off."""
    if not generation.flight_recorder:
        return None
    if generation.flightrec_ticks < 1:
        raise ValueError(
            f"[generation_service] flightrec_ticks must be >= 1, got "
            f"{generation.flightrec_ticks}")
    return FlightRecorder(capacity=generation.flightrec_ticks)


def build_engine(generation: GenerationConfig, device: DeviceLike = None,
                 params: Optional[Params] = None) -> SlotEngine:
    """Construct the slot engine from the serving config and warm it, so
    the first request pays no first-use cost.

    Sizes the process-wide request ledger (``request_ledger_size``) and
    installs the flight recorder (``flight_recorder``) and the process-wide
    tenant meter (None while the port config's accounting is off). Weights:
    ``params`` (already on the device, in the preset's dtype), else the
    checkpoint under ``checkpoint_path`` (``CheckpointLoadError`` when it
    cannot be served), else random weights from ``TransformerLM.init``
    (seed 0). ``device`` None means ``cuda`` and raises without one."""
    device = resolve_device(device)
    if generation.preset not in PRESETS:
        raise ValueError(
            f"[generation_service] preset {generation.preset!r} unknown; "
            f"choose from {sorted(PRESETS)}")
    if generation.request_ledger_size < 1:
        raise ValueError(
            f"[generation_service] request_ledger_size must be >= 1, got "
            f"{generation.request_ledger_size}")
    if generation.mesh_dp < 1 or generation.mesh_tp < 1:
        raise ValueError(
            f"[generation_service] mesh_dp/mesh_tp must be >= 1, got "
            f"{generation.mesh_dp}/{generation.mesh_tp}")
    for knob in ("mesh_dp", "mesh_tp"):
        if getattr(generation, knob) > 1:
            raise ValueError(f"{knob}={getattr(generation, knob)} is not yet "
                             "ported to tensorhive_tpu_torch")
    if params is not None and generation.checkpoint_path:
        raise ValueError("pass params or set checkpoint_path, not both")
    get_request_ledger().set_capacity(generation.request_ledger_size)
    model_config = PRESETS[generation.preset]
    max_len = generation.max_len or model_config.max_seq_len
    model_config = dataclasses.replace(
        model_config, max_seq_len=max(max_len, model_config.max_seq_len))
    if generation.checkpoint_path:
        step, params = load_checkpoint_params(
            generation.checkpoint_path, model_config, device)
        log.info("serving checkpoint %s step %d", generation.checkpoint_path,
                 step)
    elif params is None:
        params = TransformerLM.init(model_config, device=device)
    engine = SlotEngine(
        params, model_config,
        slots=generation.slots,
        max_len=max_len,
        paged=generation.paged,
        page_size=generation.page_size,
        kv_pages=generation.kv_pages,
        paged_kernel=generation.paged_kernel,
        kv_quant=generation.kv_quant,
        prefix_cache=generation.prefix_cache,
        prefix_min_tokens=generation.prefix_min_tokens,
        prefill_chunk_tokens=generation.prefill_chunk_tokens,
        speculative=generation.speculative,
        draft_preset=generation.draft_preset,
        draft_layers=generation.draft_layers,
        spec_tokens=generation.spec_tokens,
        host_kv_bytes=generation.host_kv_bytes,
        default_deadline_s=generation.default_deadline_s,
        max_deadline_s=generation.max_deadline_s,
        queue_depth=generation.queue_depth,
        top_k=generation.top_k or None,
        eos_token=None if generation.eos_token < 0 else generation.eos_token,
        max_new_tokens_cap=generation.max_new_tokens,
        max_concurrent_per_user=generation.max_concurrent_per_user,
        flight_recorder=build_flight_recorder(generation),
        tenant_meter=get_tenant_meter(),
        device=device,
    )
    engine.warmup(prompt_lens=(16, max_len // 2))
    log.info("generation engine ready: preset=%s slots=%d max_len=%d "
             "queue_depth=%d device=%s", generation.preset, engine.capacity,
             max_len, generation.queue_depth, engine.device)
    return engine
