"""Slot-based continuous-batching engine — the PyTorch counterpart of
``tensorhive_tpu/serving/engine.py`` for the paged, whole-prompt-prefill,
single-device engine.

Many generation requests share ONE running decode batch: a fixed pool of
slots over one persistent paged KV cache. A request joins by prefilling its
prompt head into pages granted from the ``PagePool`` and leaves by having
its pages released on EOS/max-tokens; every scheduler tick admits waiting
requests, then advances the whole batch one token. The host logic
(admission, validation, join/leave, cancel, drain) follows the JAX engine
method for method; the device side is eager PyTorch:

* The cache ``[layers, 1 + num_pages, page_size, kv_heads, d_head]``
  (int8 payload + f32 scales under ``kv_quant``) is allocated once and
  written IN PLACE — the JAX engine donates it through each executable to
  the same end.
* Prefill runs the trunk over the bucketed prompt head with the CUDA
  flash-forward kernel; the decode step attends through the page table
  with the CUDA paged-attention kernel. CPU tensors run each kernel's
  plain version.
* Parked slots keep stepping, masked: their position is 0 and their
  page-table row points at the trash page, so their garbage writes land
  where no live sequence reads.

Not ported yet, and refused with "not yet ported" where a knob would ask
for them: the prefix cache and chunked prefill, the contiguous layout,
the speculative lane, host KV tiering and the serving mesh. ``auto``
resolves ``prefix_cache`` and ``speculative`` to ``off``. Deadlines,
Retry-After estimation, the request ledger, tracer, tenant meter, flight
recorder and metrics also wait for later work.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import queue as queue_module
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.decode import (
    KVCache,
    QuantKVCache,
    _gumbel,
    _prefill_bucket,
)
from ..models.transformer import (
    Params,
    TransformerConfig,
    TransformerLM,
    _lm_head,
    _rmsnorm,
)
from ..ops import kv_quant as kvq
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_attention, resolve_paged_kernel
from . import EngineDrainingError, QueueFullError, RateLimitError
from .paging import PagePool


def _not_yet_ported(knob: str, value) -> ValueError:
    return ValueError(f"{knob}={value!r} is not yet ported to "
                      "tensorhive_tpu_torch")


# -- device functions ---------------------------------------------------------

def _choose_next(params: Params, x: torch.Tensor, tokens: torch.Tensor,
                 active: torch.Tensor, temps: torch.Tensor,
                 generator: torch.Generator, config: TransformerConfig,
                 top_k: Optional[int]) -> torch.Tensor:
    """Shared step tail: final norm -> f32 logits -> per-slot greedy or
    sampled choice (Gumbel-max from the engine's generator). Parked slots
    keep their token."""
    x = _rmsnorm(x, params["final_norm"]["scale"])
    logits = _lm_head(x[:, 0], params["w_lm_head"], config.dtype)  # [S, V]
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    safe_temps = torch.where(temps > 0.0, temps, 1.0)
    scaled = logits / safe_temps[:, None]
    if top_k is not None:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    sampled = torch.argmax(scaled + _gumbel(scaled.shape, generator,
                                            logits.device), dim=-1)
    chosen = torch.where(temps > 0.0, sampled.to(torch.int32), greedy)
    return torch.where(active, chosen, tokens)


def _paged_step_body(params: Params, tokens: torch.Tensor,
                     positions: torch.Tensor, active: torch.Tensor,
                     temps: torch.Tensor, page_tables: torch.Tensor,
                     cache, generator: torch.Generator,
                     config: TransformerConfig,
                     top_k: Optional[int]) -> torch.Tensor:
    """One decode step over the paged cache for the whole slot batch:
    each slot consumes the token AT its position, writes that position's
    K/V to ``(page_tables[s, pos // page_size], pos % page_size)`` in place
    (quantizing onto the page's running-max scale under int8), attends
    through the page table and returns the token for position + 1."""
    x = params["tok_embed"][tokens.long()][:, None, :]            # [S,1,D]
    rope_positions = positions[:, None]                           # [S,1]
    quant = isinstance(cache, QuantKVCache)
    page_size = cache.k.shape[2]
    slot_ids = torch.arange(tokens.shape[0], device=tokens.device)
    pages = page_tables[slot_ids, (positions // page_size).long()].long()
    offsets = (positions % page_size).long()

    def attend(q, k, v, layer):
        if quant:
            # page-table entries are always physical pages (trash
            # included): nothing can drop
            kvq.step_write(cache.k[layer], cache.k_scale[layer], pages,
                           offsets, k[:, 0])
            kvq.step_write(cache.v[layer], cache.v_scale[layer], pages,
                           offsets, v[:, 0])
        else:
            cache.k[layer][pages, offsets] = k[:, 0].to(cache.k.dtype)
            cache.v[layer][pages, offsets] = v[:, 0].to(cache.v.dtype)
        return paged_attention(
            q, cache.k[layer], cache.v[layer], page_tables, positions,
            k_scales=cache.k_scale[layer] if quant else None,
            v_scales=cache.v_scale[layer] if quant else None)

    for layer_index, block in enumerate(params["blocks"]):
        x = TransformerLM.block_forward(x, block, config, rope_positions,
                                        attend, layer_index=layer_index)
    return _choose_next(params, x, tokens, active, temps, generator, config,
                        top_k)


def _paged_prefill_body(params: Params, head: torch.Tensor, cache,
                        page_table_row: torch.Tensor, real_len: int,
                        config: TransformerConfig) -> None:
    """Prefill one joining sequence's prompt head through its page table.
    ``head`` [1, W] is padded to a bucket; prompt position ``w < real_len``
    writes to ``(page_table_row[w // page_size], w % page_size)``. Padded
    positions write NOTHING — not even to the trash page — and the decode
    steps rewrite every later position before first attending it."""
    batch, width = head.shape
    x = params["tok_embed"][head.long()]
    positions = torch.arange(width, dtype=torch.int32,
                             device=head.device).expand(batch, width)
    page_size = cache.k.shape[2]
    quant = isinstance(cache, QuantKVCache)
    token_index = torch.arange(width, device=head.device)
    valid = token_index < real_len
    written = token_index[:real_len]
    pages = page_table_row.long()[written // page_size]
    offsets = written % page_size

    def attend(q, k, v, layer):
        if quant:
            # quantize-on-write through the row; the prompt attends its
            # own unquantized k/v below, exactly like the bf16/f32 path
            kvq.row_merge(cache.k[layer], cache.k_scale[layer],
                          page_table_row[None], k, token_index[None],
                          valid[None], config.dtype)
            kvq.row_merge(cache.v[layer], cache.v_scale[layer],
                          page_table_row[None], v, token_index[None],
                          valid[None], config.dtype)
        else:
            cache.k[layer][pages, offsets] = k[0, :real_len].to(cache.k.dtype)
            cache.v[layer][pages, offsets] = v[0, :real_len].to(cache.v.dtype)
        return flash_attention(q, k, v, causal=True)

    for layer_index, block in enumerate(params["blocks"]):
        x = TransformerLM.block_forward(x, block, config, positions, attend,
                                        layer_index=layer_index)


# -- host side ----------------------------------------------------------------

#: handle event kinds
TOKEN, DONE = "token", "done"

_request_ids = itertools.count(1)


class GenerationHandle:
    """Consumer side of one request: a bounded event stream plus final
    summary. ``tokens()`` is what a streaming endpoint iterates."""

    def __init__(self, engine: "SlotEngine", request: "_Request") -> None:
        self._engine = engine
        self._request = request
        self._events: "queue_module.Queue[tuple]" = queue_module.Queue()
        self._summary: Optional[Dict] = None

    def _push(self, kind: str, payload: object) -> None:
        self._events.put((kind, payload))

    def tokens(self, timeout_s: float = 30.0):
        """Yield generated token ids as they are produced. Raises
        ``TimeoutError`` when nothing arrives for ``timeout_s``."""
        while True:
            try:
                kind, payload = self._events.get(timeout=timeout_s)
            except queue_module.Empty:
                self.cancel()
                raise TimeoutError(
                    f"no token within {timeout_s:.0f}s") from None
            if kind == DONE:
                self._summary = payload
                return
            yield payload

    def result(self, timeout_s: float = 30.0) -> Dict:
        """Drain the stream and return the completion summary."""
        if self._summary is None:
            for _ in self.tokens(timeout_s=timeout_s):
                pass
        if self._summary is None:
            raise RuntimeError("stream ended without a summary")
        return self._summary

    def cancel(self) -> None:
        """Mark the request cancelled; the engine frees its slot (or drops
        it from the queue) at the next scheduler iteration."""
        self._engine._cancel(self._request)

    @property
    def done(self) -> bool:
        return self._request.finished

    @property
    def request_id(self) -> str:
        return self._request.request_id


@dataclasses.dataclass
class _Request:
    prompt: List[int]
    max_new_tokens: int
    temperature: float
    user_key: Optional[str]
    submitted_ts: float
    request_id: str = ""
    handle: Optional[GenerationHandle] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    first_token_ts: Optional[float] = None
    last_token_ts: Optional[float] = None
    cancelled: bool = False
    finished: bool = False


class SlotEngine:
    """The continuous-batching scheduler + device state.

    Host bookkeeping (queue, slot table, per-user counts) is guarded by one
    lock; device work runs outside it, from the single thread that calls
    ``step``/``pump``, so submitters never wait behind a decode step."""

    def __init__(
        self,
        params: Params,
        config: TransformerConfig,
        *,
        slots: int = 8,
        max_len: Optional[int] = None,
        queue_depth: int = 32,
        top_k: Optional[int] = None,
        eos_token: Optional[int] = None,
        max_new_tokens_cap: int = 512,
        max_concurrent_per_user: int = 0,
        paged: bool = True,
        page_size: int = 16,
        kv_pages: int = 0,
        paged_kernel: str = "auto",
        kv_quant: str = "auto",
        prefix_cache: str = "auto",
        speculative: str = "auto",
        host_kv_bytes: int = 0,
        mesh=None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        if not config.causal:
            raise ValueError("serving needs an autoregressive model; this "
                             "config is a bidirectional encoder")
        if not paged:
            raise _not_yet_ported("paged", paged)
        if prefix_cache not in ("auto", "on", "off"):
            raise ValueError(
                f"prefix_cache must be auto|on|off, got {prefix_cache!r}")
        if prefix_cache == "on":
            raise _not_yet_ported("prefix_cache", prefix_cache)
        if speculative not in ("auto", "on", "off"):
            raise ValueError(
                f"speculative must be auto|on|off, got {speculative!r}")
        if speculative == "on":
            raise _not_yet_ported("speculative", speculative)
        if host_kv_bytes < 0:
            raise ValueError(
                f"host_kv_bytes must be >= 0, got {host_kv_bytes}")
        if host_kv_bytes > 0:
            raise _not_yet_ported("host_kv_bytes", host_kv_bytes)
        if mesh is not None:
            raise _not_yet_ported("mesh", mesh)
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if top_k is not None and not 0 < top_k <= config.vocab_size:
            raise ValueError(
                f"top_k must be in (0, {config.vocab_size}], got {top_k}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if params["tok_embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['tok_embed'].device}, "
                             f"the engine on {self.device}")
        self.params = params
        self.config = config
        self.capacity = int(slots)
        self.max_len = int(max_len or config.max_seq_len)
        self.queue_depth = int(queue_depth)
        self.top_k = top_k
        self.eos_token = eos_token
        self.max_new_tokens_cap = int(max_new_tokens_cap)
        self.max_concurrent_per_user = int(max_concurrent_per_user)
        self.paged = True
        self.prefix_cache = "off"
        self.speculative = "off"
        self.kv_quant = kvq.resolve_kv_quant(kv_quant, self.paged)
        self._quant = self.kv_quant == "on"
        self.paged_kernel = resolve_paged_kernel(paged_kernel)
        self._draining = False

        self._lock = threading.Lock()
        self._pending: Deque[_Request] = collections.deque()
        #: the request each slot serves (None = free)
        self._slots: List[Optional[_Request]] = [None] * self.capacity
        self._user_active: Dict[str, int] = {}
        self.completed_requests = 0
        self.emitted_tokens = 0
        self.steps = 0
        #: device dispatches (warmup's included): each decode step launches
        #: the paged-attention kernel once per layer, each prefill the
        #: flash kernel once per layer
        self.step_dispatches = 0
        self.prefills = 0

        self.page_size = int(page_size)
        max_pages_per_slot = -(-self.max_len // self.page_size)
        itemsize = torch.empty((), dtype=config.dtype).element_size()
        dtype_page = kvq.page_bytes(self.page_size, config.kv_heads,
                                    config.d_head, itemsize)
        quant_page = kvq.quant_page_bytes(self.page_size, config.kv_heads,
                                          config.d_head)
        #: bytes one page costs across all layers (payload + int8 scales)
        self._page_bytes = config.n_layers * (quant_page if self._quant
                                              else dtype_page)
        if kv_pages:
            num_pages = int(kv_pages)
        else:
            # 0 = the contiguous layout's bytes at this slot count; int8
            # pages fit that budget more times over
            num_pages = self.capacity * max_pages_per_slot
            if self._quant:
                num_pages = num_pages * dtype_page // quant_page
        self._pool = PagePool(num_pages=num_pages, page_size=self.page_size,
                              slots=self.capacity,
                              max_pages_per_slot=max_pages_per_slot)
        shape = (config.n_layers, self._pool.physical_pages, self.page_size,
                 config.kv_heads, config.d_head)
        if self._quant:
            scale_shape = (config.n_layers, shape[1], config.kv_heads)
            self._cache = QuantKVCache(
                k=torch.zeros(shape, dtype=torch.int8, device=self.device),
                v=torch.zeros(shape, dtype=torch.int8, device=self.device),
                k_scale=torch.zeros(scale_shape, dtype=torch.float32,
                                    device=self.device),
                v_scale=torch.zeros(scale_shape, dtype=torch.float32,
                                    device=self.device))
        else:
            self._cache = KVCache(
                k=torch.zeros(shape, dtype=config.dtype, device=self.device),
                v=torch.zeros(shape, dtype=config.dtype, device=self.device))
        # per-slot state: host numpy masters, shipped to the device per step
        self._tokens = np.zeros(self.capacity, np.int32)
        self._positions = np.zeros(self.capacity, np.int32)
        self._active = np.zeros(self.capacity, bool)
        self._temps = np.zeros(self.capacity, np.float32)
        self._generator = torch.Generator(device=self.device).manual_seed(0)

    @property
    def kv_cache_bytes(self) -> int:
        """Device bytes of the KV cache (payload + scales)."""
        return sum(t.numel() * t.element_size() for t in self._cache)

    def _operand(self, value: np.ndarray) -> torch.Tensor:
        """Ship one per-slot host array to the engine's device."""
        return torch.from_numpy(value).to(self.device)

    # -- admission --------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               temperature: float = 0.0,
               user_key: Optional[str] = None) -> GenerationHandle:
        """Queue one request; raises ``ValueError`` on malformed input (and
        on a request the page pool can never hold), ``RateLimitError``/
        ``QueueFullError`` on admission failure, ``EngineDrainingError``
        while the engine drains."""
        if self._draining:
            raise EngineDrainingError(
                "engine is draining: in-flight requests are finishing, no "
                "new admissions; retry after the drain completes")
        prompt = [int(token) for token in prompt]
        if not prompt:
            raise ValueError("prompt must contain at least one token")
        if any(not 0 <= t < self.config.vocab_size for t in prompt):
            raise ValueError(
                f"prompt tokens must be in [0, {self.config.vocab_size})")
        if not 1 <= max_new_tokens <= self.max_new_tokens_cap:
            raise ValueError(
                f"max_new_tokens must be in [1, {self.max_new_tokens_cap}], "
                f"got {max_new_tokens}")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt+new = {len(prompt) + max_new_tokens} exceeds the "
                f"engine sequence budget {self.max_len}")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        needed = self._pool.pages_for(len(prompt) + max_new_tokens)
        if needed > self._pool.num_pages:
            raise ValueError(
                f"request needs {needed} KV pages but the pool only has "
                f"{self._pool.num_pages}; shorten the prompt or "
                "max_new_tokens")
        request = _Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                           temperature=float(temperature),
                           user_key=str(user_key) if user_key else None,
                           submitted_ts=time.monotonic(),
                           request_id=f"req-{next(_request_ids)}")
        handle = GenerationHandle(self, request)
        request.handle = handle
        with self._lock:
            if (self.max_concurrent_per_user > 0 and request.user_key
                    and self._user_active.get(request.user_key, 0)
                    >= self.max_concurrent_per_user):
                raise RateLimitError(
                    f"user has {self.max_concurrent_per_user} generation "
                    "requests in flight; retry when one completes",
                    request_id=request.request_id)
            if len(self._pending) >= self.queue_depth:
                raise QueueFullError(
                    f"admission queue is full ({self.queue_depth} waiting); "
                    "retry shortly", request_id=request.request_id)
            if request.user_key:
                self._user_active[request.user_key] = (
                    self._user_active.get(request.user_key, 0) + 1)
            self._pending.append(request)
        return handle

    def _cancel(self, request: _Request) -> None:
        with self._lock:
            if not request.finished:
                request.cancelled = True

    # -- drain -------------------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self) -> None:
        """Stop admitting; queued and running requests keep finishing.
        Idempotent."""
        self._draining = True

    def resume(self) -> None:
        """Re-open admission after a drain. Idempotent."""
        self._draining = False

    # -- scheduler --------------------------------------------------------
    def has_work(self) -> bool:
        with self._lock:
            return (bool(self._pending)
                    or any(request is not None for request in self._slots))

    def step(self) -> int:
        """One scheduler iteration: admit joins (each prefills its prompt),
        then advance the running batch one token. Returns the number of
        active slots stepped."""
        self._admit()
        return self._decode_step()

    def pump(self, budget_s: Optional[float] = None,
             should_stop: Optional[Callable[[], bool]] = None) -> int:
        """Run scheduler iterations until idle, the wall budget is spent,
        or ``should_stop()``."""
        deadline = None if budget_s is None else time.monotonic() + budget_s
        steps = 0
        while self.has_work():
            if should_stop is not None and should_stop():
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            self.step()
            steps += 1
        return steps

    def warmup(self, prompt_lens: Sequence[int] = ()) -> None:
        """Run the prefill for each bucket the given prompt lengths map to
        (the smallest bucket when none are given) and one decode step, so
        the first request pays no first-use cost (kernel build and load,
        library initialisation). Every prefill write is dropped (real
        length 0) and the step only writes the trash page."""
        buckets = {_prefill_bucket(max(1, length - 1), self.max_len - 1)
                   for length in prompt_lens} or {
                       _prefill_bucket(1, self.max_len - 1)}
        for width in sorted(buckets):
            self._dispatch_prefill(np.zeros((1, width), np.int32), slot=0,
                                   real_len=0)
        self._run_step().cpu()

    # -- internals --------------------------------------------------------
    def _dispatch_prefill(self, head: np.ndarray, slot: int,
                          real_len: int) -> None:
        self.prefills += 1
        _paged_prefill_body(self.params, self._operand(head), self._cache,
                            self._operand(self._pool.page_table[slot]),
                            int(real_len), self.config)

    def _run_step(self) -> torch.Tensor:
        self.step_dispatches += 1
        return _paged_step_body(
            self.params, self._operand(self._tokens),
            self._operand(self._positions), self._operand(self._active),
            self._operand(self._temps), self._operand(self._pool.page_table),
            self._cache, self._generator, self.config, self.top_k)

    def _admit(self) -> int:
        """Move pending requests into free slots (head of line first; a
        request waits while the pool cannot grant its pages)."""
        joined = 0
        while True:
            with self._lock:
                self._drop_cancelled_pending_locked()
                free = next((index for index, slot
                             in enumerate(self._slots) if slot is None), None)
                if free is None or not self._pending:
                    return joined
                request = self._pending[0]
                needed = self._pool.pages_for(
                    len(request.prompt) + request.max_new_tokens)
                if not self._pool.assign(free, needed):
                    # strict FIFO: smaller requests never overtake, so long
                    # ones cannot starve (submit() rejected the impossible)
                    return joined
                self._pending.popleft()
                self._slots[free] = request
            self._join(free, request)
            joined += 1

    def _drop_cancelled_pending_locked(self) -> None:
        kept: Deque[_Request] = collections.deque()
        for request in self._pending:
            if request.cancelled:
                self._finish_locked(request, outcome="cancelled")
            else:
                kept.append(request)
        self._pending = kept

    def _join(self, slot: int, request: _Request) -> None:
        """Prefill the prompt head (all but the last token) into the slot's
        pages and arm its per-slot state; the next decode step consumes the
        last prompt token and emits the first generated one."""
        prompt = request.prompt
        prompt_len = len(prompt)
        if prompt_len > 1:
            width = _prefill_bucket(prompt_len - 1, self.max_len - 1)
            head = np.zeros((1, width), np.int32)
            head[0, :prompt_len - 1] = prompt[:-1]
            try:
                self._dispatch_prefill(head, slot, prompt_len - 1)
            except Exception:
                # a failed prefill must not wedge the slot: free it and
                # requeue the request at the head before re-raising
                with self._lock:
                    if self._slots[slot] is request:
                        self._free_slot_locked(slot)
                    self._pending.appendleft(request)
                raise
        with self._lock:
            self._tokens[slot] = prompt[-1]
            self._positions[slot] = prompt_len - 1
            self._temps[slot] = request.temperature
            self._active[slot] = True

    def _decode_step(self) -> int:
        with self._lock:
            stepped = [(index, request)
                       for index, request in enumerate(self._slots)
                       if request is not None and bool(self._active[index])]
        if not stepped:
            return 0
        emitted = self._run_step().cpu().numpy()
        now = time.monotonic()
        with self._lock:
            self.steps += 1
            for index, request in stepped:
                if self._slots[index] is not request:
                    continue        # freed between snapshot and apply
                token = int(emitted[index])
                self._tokens[index] = token
                self._positions[index] += 1
                self._apply_token_locked(index, request, token, now)
        return len(stepped)

    def _apply_token_locked(self, index: int, request: _Request,
                            token: int, now: float) -> None:
        if request.cancelled:
            self._free_slot_locked(index)
            self._finish_locked(request, outcome="cancelled")
            return
        request.generated.append(token)
        self.emitted_tokens += 1
        if request.first_token_ts is None:
            request.first_token_ts = now
        request.last_token_ts = now
        if request.handle is not None:
            request.handle._push(TOKEN, token)
        hit_eos = self.eos_token is not None and token == self.eos_token
        if hit_eos or len(request.generated) >= request.max_new_tokens:
            self._free_slot_locked(index)
            self._finish_locked(request, outcome="completed")

    def _free_slot_locked(self, index: int) -> None:
        """Release the slot's pages NOW (they may be reassigned on the next
        admission): the row points back at the trash page and the position
        resets to 0, so the parked slot's writes land at (trash, 0)."""
        self._slots[index] = None
        self._active[index] = False
        self._pool.release(index)
        self._positions[index] = 0

    def _finish_locked(self, request: _Request, outcome: str) -> None:
        """Terminal bookkeeping, exactly once per request."""
        if request.finished:
            return
        request.finished = True
        now = time.monotonic()
        if outcome == "completed":
            self.completed_requests += 1
        if request.user_key:
            remaining = self._user_active.get(request.user_key, 1) - 1
            if remaining <= 0:
                self._user_active.pop(request.user_key, None)
            else:
                self._user_active[request.user_key] = remaining
        if request.handle is None:
            return
        request.handle._push(DONE, {
            "requestId": request.request_id,
            "tokens": list(request.generated),
            "outcome": outcome,
            "ttftS": (round(request.first_token_ts - request.submitted_ts, 6)
                      if request.first_token_ts is not None else None),
            "durationS": round(now - request.submitted_ts, 6),
        })

    # -- introspection ----------------------------------------------------
    def _busy_locked(self) -> int:
        return sum(1 for request in self._slots if request is not None)

    def stats(self) -> Dict:
        """Engine snapshot (a subset of the JAX engine's ``stats``)."""
        with self._lock:
            return {
                "slots": self.capacity,
                "slotsBusy": self._busy_locked(),
                "queueDepth": len(self._pending),
                "queueCapacity": self.queue_depth,
                "draining": self._draining,
                "maxSeqLen": self.max_len,
                "device": str(self.device),
                "paged": self.paged,
                "pageSize": self.page_size,
                "pagedKernel": self.paged_kernel,
                "kvPagesTotal": self._pool.num_pages,
                "kvPagesFree": self._pool.free_pages,
                "kvQuant": self.kv_quant,
                "kvBytesPerToken": round(self._page_bytes / self.page_size,
                                         1),
                "prefixCache": self.prefix_cache,
                "speculative": self.speculative,
                "requestsCompleted": self.completed_requests,
                "tokensEmitted": self.emitted_tokens,
                "steps": self.steps,
                "stepDispatches": self.step_dispatches,
                "prefills": self.prefills,
            }
