"""Slot-based continuous-batching engine — the PyTorch counterpart of
``tensorhive_tpu/serving/engine.py`` for the single-device engine, paged
or contiguous.

Many generation requests share ONE running decode batch: a fixed pool of
slots over one persistent KV cache. Every scheduler tick admits waiting
requests, advances each prefill in progress by one chunk, then advances
the whole batch one token. The host logic (admission, validation,
join/leave, cancel, drain) follows the JAX engine method for method; the
device side is eager PyTorch:

* The cache is allocated once and written IN PLACE (the JAX engine donates
  it through each executable to the same end): paged ``[layers, 1 +
  num_pages, page_size, kv_heads, d_head]`` (int8 payload + f32 scales
  under ``kv_quant``; one page more with the speculative lane on, the page
  that takes the writes JAX drops), or contiguous ``[layers, slots,
  max_len, kv_heads, d_head]`` under ``paged=False``.
* **Prefix cache + chunked prefill** (``prefix_cache`` auto = on for the
  paged layout, as in JAX). A radix tree (``prefix_cache.py``) maps shared
  prompt prefixes to page runs: admission grants the matched pages shared
  and charges only the suffix, and every prefill — misses included — runs
  through :func:`_paged_chunk_prefill_body`, one chunk of
  ``prefill_chunk_tokens`` per tick, so a long join never stalls the
  running batch. The chunk attends the slot's gathered page run in plain
  f32 (:func:`_chunk_attend`; the JAX package leaves it to XLA).
* ``prefix_cache="off"`` prefills each prompt whole inside the join, with
  the CUDA flash-forward kernel; the contiguous layout does the same into
  the slot's row. The paged decode step attends through the page table
  with the CUDA paged-attention kernel; the contiguous step runs the plain
  masked decode attention (XLA code in JAX). CPU tensors run each kernel's
  plain version.
* Parked slots keep stepping, masked: a freed paged slot's position is 0
  and its page-table row points at the trash page; a slot mid-prefill has
  its row sent to the trash page in the step's operand; a freed
  contiguous slot writes its own row at its frozen position.
* **Speculative decoding** (``speculative``; ``auto`` = on where the
  engine runs on the card, off on the CPU): a draft model
  (``speculative.py``) proposes ``spec_tokens`` tokens per slot, one
  batched target pass verifies them and the longest matching prefix is
  accepted, so greedy output equals the plain step's. Every prefill is
  mirrored into the draft lane; each tick is one propose and one verify
  instead of the plain step.

Not ported yet, and refused with "not yet ported" where a knob asks for
them: host KV tiering and the serving mesh. Deadlines, Retry-After
estimation, the request ledger, tracer, tenant meter, flight recorder and
metrics also wait for later work.
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
from ..ops.flash_attention import NEG_INF, flash_attention
from ..ops.paged_attention import (
    decode_attention,
    paged_attention,
    resolve_paged_kernel,
)
from . import EngineDrainingError, QueueFullError, RateLimitError
from .paging import TRASH_PAGE, PagePool
from .prefix_cache import PrefixCache
from .speculative import (
    SpeculativeLane,
    _paged_spec_verify_body,
    _spec_verify_body,
    build_draft,
    resolve_speculative,
)


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


def _step_body(params: Params, tokens: torch.Tensor,
               positions: torch.Tensor, active: torch.Tensor,
               temps: torch.Tensor, cache: KVCache,
               generator: torch.Generator, config: TransformerConfig,
               top_k: Optional[int]) -> torch.Tensor:
    """One decode step over the CONTIGUOUS cache for the whole slot batch:
    each slot consumes the token AT its position, writes that position's
    K/V into its own row ``(layer, slot, position)`` in place, attends its
    row masked to ``key <= position`` (the plain masked decode attention,
    positions broadcast per slot) and returns the token for position + 1."""
    x = params["tok_embed"][tokens.long()][:, None, :]            # [S,1,D]
    rope_positions = positions[:, None]                           # [S,1]
    slot_ids = torch.arange(tokens.shape[0], device=tokens.device)
    write_positions = positions.long()

    def attend(q, k, v, layer):
        cache.k[layer][slot_ids, write_positions] = k[:, 0].to(cache.k.dtype)
        cache.v[layer][slot_ids, write_positions] = v[:, 0].to(cache.v.dtype)
        return decode_attention(q, cache.k[layer], cache.v[layer],
                                positions[:, None, None, None, None])

    for layer_index, block in enumerate(params["blocks"]):
        x = TransformerLM.block_forward(x, block, config, rope_positions,
                                        attend, layer_index=layer_index)
    return _choose_next(params, x, tokens, active, temps, generator, config,
                        top_k)


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


def _prefill_body(params: Params, head: torch.Tensor, cache: KVCache,
                  slot: int, real_len: int,
                  config: TransformerConfig) -> None:
    """Prefill one joining sequence's prompt head into its CONTIGUOUS slot
    row: ``head`` [1, W] is padded to a bucket, positions ``w < real_len``
    write their K/V to ``(layer, slot, w)`` and padded positions write
    zeros; the prompt attends itself through the flash-forward kernel."""
    batch, width = head.shape
    x = params["tok_embed"][head.long()]
    positions = torch.arange(width, dtype=torch.int32,
                             device=head.device).expand(batch, width)
    valid = (torch.arange(width, device=head.device)
             < real_len)[None, :, None, None]

    def attend(q, k, v, layer):
        cache.k[layer, slot, :width] = torch.where(valid, k, 0)[0].to(
            cache.k.dtype)
        cache.v[layer, slot, :width] = torch.where(valid, v, 0)[0].to(
            cache.v.dtype)
        return flash_attention(q, k, v, causal=True)

    for layer_index, block in enumerate(params["blocks"]):
        x = TransformerLM.block_forward(x, block, config, positions, attend,
                                        layer_index=layer_index)


def _chunk_attend(q: torch.Tensor, k_ctx: torch.Tensor, v_ctx: torch.Tensor,
                  q_positions: torch.Tensor) -> torch.Tensor:
    """Attention for a prefill chunk that need not start at position 0:
    queries [1, W, H, Dh] against the slot's whole gathered page run
    [K, Hkv, Dh] (cached prefix + earlier chunks + this chunk's own
    writes, in logical order), masked to ``key_pos <= q_pos``. The JAX
    function term for term: GQA expanded (head h uses KV head h //
    group), f32 scores and probabilities, the same scale. Keys past a
    query's position hold trash or unwritten cells; the mask sends them to
    NEG_INF, the softmax underflows them to exactly 0.0, and 0.0 times a
    finite value adds exact zeros."""
    if k_ctx.shape[1] != q.shape[2]:
        group = q.shape[2] // k_ctx.shape[1]
        k_ctx = k_ctx.repeat_interleave(group, dim=1)
        v_ctx = v_ctx.repeat_interleave(group, dim=1)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,khd->bhqk", q.to(torch.float32),
                          k_ctx.to(torch.float32)) * scale
    key_positions = torch.arange(k_ctx.shape[0], device=q.device)
    mask = key_positions[None, None, None, :] <= q_positions[None, None, :,
                                                             None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,khd->bqhd", probs, v_ctx.to(torch.float32))
    return out.to(q.dtype)


def _paged_chunk_prefill_body(params: Params, head: torch.Tensor, cache,
                              page_table_row: torch.Tensor, start: int,
                              real_len: int,
                              config: TransformerConfig) -> None:
    """Prefill ONE CHUNK of a joining prompt, starting mid-sequence — the
    body of the prefix cache and of chunked prefill. ``head`` [1, W] holds
    prompt positions ``start .. start + real_len - 1`` (W a bucket, the
    tail zero-padded). Position ``start + w`` writes its K/V to
    ``(page_table_row[(start + w) // ps], (start + w) % ps)``; padded
    positions write nothing. Queries at ``start + w`` must see positions
    ``0 .. start + w``, whose K/V live in the slot's pages (shared prefix
    pages, earlier chunks): writes land first, then the whole row gathers
    in logical order and :func:`_chunk_attend` applies the positional
    mask. Under int8 pages the write goes through ``kvq.row_merge`` and the
    chunk attends the DEQUANTIZED post-write context it returns — what any
    later reader (a prefix-cache hit above all) dequantizes."""
    batch, width = head.shape
    x = params["tok_embed"][head.long()]
    chunk_offsets = torch.arange(width, dtype=torch.int32, device=head.device)
    global_positions = start + chunk_offsets                      # [W]
    positions = global_positions.expand(batch, width)
    page_size = cache.k.shape[2]
    valid = chunk_offsets < real_len
    window = page_table_row.shape[0] * page_size
    safe_logical = torch.clamp(global_positions, 0, window - 1)
    written = global_positions[:real_len].long()
    row = page_table_row.long()
    pages = row[written // page_size]
    page_offsets = written % page_size
    quant = isinstance(cache, QuantKVCache)

    def attend(q, k, v, layer):
        if quant:
            _, _, ctx_k = kvq.row_merge(
                cache.k[layer], cache.k_scale[layer], page_table_row[None],
                k, safe_logical[None], valid[None], config.dtype)
            _, _, ctx_v = kvq.row_merge(
                cache.v[layer], cache.v_scale[layer], page_table_row[None],
                v, safe_logical[None], valid[None], config.dtype)
            return _chunk_attend(q, ctx_k[0], ctx_v[0], global_positions)
        cache.k[layer][pages, page_offsets] = k[0, :real_len].to(
            cache.k.dtype)
        cache.v[layer][pages, page_offsets] = v[0, :real_len].to(
            cache.v.dtype)
        # gather AFTER the writes: within-chunk causality comes from the
        # positional mask, as in the decode step's write-then-attend
        ctx_k = cache.k[layer][row].reshape(window, *cache.k.shape[3:])
        ctx_v = cache.v[layer][row].reshape(window, *cache.v.shape[3:])
        return _chunk_attend(q, ctx_k, ctx_v, global_positions)

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


@dataclasses.dataclass
class _Slot:
    request: _Request
    joined_ts: float
    #: tokens the prefix cache let this request skip (0 = full miss)
    cached_tokens: int = 0
    #: next prompt position to prefill; == prefill_target once armed
    prefill_next: int = 0
    #: last prompt position exclusive (prompt_len - 1; the final token
    #: goes through the decode step, as everywhere)
    prefill_target: int = 0
    #: False while chunks are still being dispatched — the slot is held
    #: out of the decode batch (active stays False) until armed
    prefill_done: bool = True
    prefill_chunks: int = 0
    prefill_ms: float = 0.0
    prefill_started_ts: float = 0.0




class SlotEngine:
    """The continuous-batching scheduler + device state.

    Host bookkeeping (queue, slot table, per-user counts, the page pool and
    the prefix cache) is guarded by one lock; device work runs outside it,
    from the single thread that calls ``step``/``pump``, so submitters
    never wait behind a decode step."""

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
        prefix_min_tokens: int = 32,
        prefill_chunk_tokens: int = 256,
        speculative: str = "auto",
        draft_preset: str = "",
        draft_layers: int = 0,
        spec_tokens: int = 4,
        host_kv_bytes: int = 0,
        mesh=None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        if not config.causal:
            raise ValueError("serving needs an autoregressive model; this "
                             "config is a bidirectional encoder")
        if prefix_cache not in ("auto", "on", "off"):
            raise ValueError(
                f"prefix_cache must be auto|on|off, got {prefix_cache!r}")
        if not paged and prefix_cache == "on":
            raise ValueError(
                "prefix_cache=on needs the paged cache layout (pages are "
                "the sharing unit); set paged=true or prefix_cache=auto/off")
        if prefill_chunk_tokens < 0:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 0, got "
                f"{prefill_chunk_tokens}")
        if spec_tokens < 1:
            raise ValueError(f"spec_tokens must be >= 1, got {spec_tokens}")
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
        self.paged = bool(paged)
        self.speculative = resolve_speculative(speculative, self.device)
        self.spec_tokens = int(spec_tokens)
        self.kv_quant = kvq.resolve_kv_quant(kv_quant, self.paged)
        self._quant = self.kv_quant == "on"
        self._draining = False

        self._lock = threading.Lock()
        self._pending: Deque[_Request] = collections.deque()
        #: each slot's request and prefill state (None = free)
        self._slots: List[Optional[_Slot]] = [None] * self.capacity
        self._user_active: Dict[str, int] = {}
        self.completed_requests = 0
        self.emitted_tokens = 0
        self.steps = 0
        #: device dispatches (warmup's included): each paged decode step
        #: launches the paged-attention kernel once per layer; each
        #: whole-prompt prefill (``prefills``) the flash kernel once per
        #: layer; a prefill chunk (``prefill_chunks``) launches neither
        self.step_dispatches = 0
        self.prefills = 0
        self.prefill_chunks = 0
        #: draft-lane propose calls (warmup's included): each launches the
        #: paged-attention kernel draft_layers x (spec_tokens - 1) times;
        #: on a speculative engine ``step_dispatches`` counts verify passes,
        #: and the draft lane's prefill mirrors add to neither ``prefills``
        #: nor ``prefill_chunks``
        self.draft_dispatches = 0

        if self.paged:
            if page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            self.page_size = int(page_size)
            self.paged_kernel = resolve_paged_kernel(paged_kernel)
            max_pages_per_slot = -(-self.max_len // self.page_size)
            itemsize = torch.empty((), dtype=config.dtype).element_size()
            dtype_page = kvq.page_bytes(self.page_size, config.kv_heads,
                                        config.d_head, itemsize)
            quant_page = kvq.quant_page_bytes(self.page_size,
                                              config.kv_heads, config.d_head)
            #: bytes one page costs across all layers (payload + scales)
            self._page_bytes = config.n_layers * (quant_page if self._quant
                                                  else dtype_page)
            if kv_pages:
                num_pages = int(kv_pages)
            else:
                # 0 = the contiguous layout's bytes at this slot count;
                # int8 pages fit that budget more times over
                num_pages = self.capacity * max_pages_per_slot
                if self._quant:
                    num_pages = num_pages * dtype_page // quant_page
            self._pool: Optional[PagePool] = PagePool(
                num_pages=num_pages, page_size=self.page_size,
                slots=self.capacity, max_pages_per_slot=max_pages_per_slot)
            # a speculative engine's cache holds one page past the pool:
            # the drop page of speculative.drop_page
            shape = (config.n_layers,
                     self._pool.physical_pages + (self.speculative == "on"),
                     self.page_size, config.kv_heads, config.d_head)
        else:
            self.page_size = None
            self.paged_kernel = None
            self._page_bytes = None
            self._pool = None
            shape = (config.n_layers, self.capacity, self.max_len,
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

        # radix prefix cache + chunked prefill: auto = on for the paged
        # layout, off for the contiguous one (no pages, nothing to share).
        # On, EVERY prefill (misses included, from position 0) runs through
        # the chunked body; off keeps the whole-prompt prefill.
        self.prefix_cache = ("on" if self.paged and prefix_cache != "off"
                             else "off")
        self.prefix_min_tokens = max(0, int(prefix_min_tokens))
        #: per-chunk position budget; 0 = one chunk per prompt
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self._use_chunk_prefill = self.prefix_cache == "on"
        self._prefix = (PrefixCache(self._pool,
                                    min_tokens=self.prefix_min_tokens)
                        if self._use_chunk_prefill else None)
        self.prefix_hits = 0
        self.prefix_misses = 0

        # the speculative lane: with it on, every tick is one draft propose
        # and one batched verify; the plain step is never dispatched
        self._spec: Optional[SpeculativeLane] = None
        if self.speculative == "on":
            self._spec = SpeculativeLane(self, *build_draft(
                params, config, draft_preset=draft_preset,
                draft_layers=draft_layers))
        self.spec_proposed = 0
        self.spec_accepted = 0
        #: per-slot tokens accepted since the draft lane last caught up
        #: (the right-aligned propose window; [] while the slot is free)
        self._spec_windows: List[List[int]] = [[] for _ in
                                               range(self.capacity)]
        #: per-slot last legal write position (prompt + max_new - 1); -1
        #: for free slots, so speculative writes to them never land
        self._pos_limits = np.full(self.capacity, -1, np.int32)

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
        if self.paged:
            needed = self._pool.pages_for(len(prompt) + max_new_tokens)
            if needed > self._pool.num_pages:
                raise ValueError(
                    f"request needs {needed} KV pages but the pool only "
                    f"has {self._pool.num_pages}; shorten the prompt or "
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
                    or any(slot is not None for slot in self._slots))

    def step(self) -> int:
        """One scheduler iteration: admit joins, advance every prefill in
        progress by ONE chunk (``prefill_chunk_tokens`` bounds the prefill
        work a tick inserts between two decode steps), then advance the
        running batch one token. Returns the number of active slots
        stepped."""
        self._admit()
        self._advance_prefills()
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
        """Run each prefill width the given prompt lengths map to and one
        decode step, so the first request pays no first-use cost (kernel
        build and load, library initialisation). Whole-prompt engines run
        the bucket of each length (the smallest bucket when none are
        given); chunked engines run each length's chunk widths plus the
        floor bucket (cache-hit suffixes are usually short). Every prefill
        write is dropped (real length 0) and the step only writes the
        trash page (paged) or slot rows no request holds (contiguous). A
        speculative engine also runs the draft lane's prefill mirrors, and
        one propose and one verify instead of the step."""
        if self._use_chunk_prefill:
            widths = {_prefill_bucket(1, self.max_len - 1)}
            for length in prompt_lens:
                remaining = max(1, length - 1)
                while remaining > 0:
                    chunk = min(remaining,
                                self.prefill_chunk_tokens or remaining)
                    widths.add(_prefill_bucket(chunk, self.max_len - 1))
                    remaining -= chunk
            for width in sorted(widths):
                self._dispatch_chunk_prefill(np.zeros((1, width), np.int32),
                                             slot=0, start=0, real_len=0)
                if self._spec is not None:
                    self._spec.chunk_prefill(np.zeros((1, width), np.int32),
                                             0, 0, 0)
        else:
            buckets = {_prefill_bucket(max(1, length - 1), self.max_len - 1)
                       for length in prompt_lens} or {
                           _prefill_bucket(1, self.max_len - 1)}
            for width in sorted(buckets):
                self._dispatch_prefill(np.zeros((1, width), np.int32),
                                       slot=0, real_len=0)
                if self._spec is not None:
                    self._spec.prefill(np.zeros((1, width), np.int32), 0, 0)
        if self._spec is None:
            self._run_step().cpu()
            return
        # a fresh engine's operands: empty windows, limits -1, every row
        # at the trash page, so no speculative write lands on a real page
        with self._lock:
            window, lens, limits, page_table = self._spec_operands_locked()
        proposals = self._spec.propose(window, lens, self._positions, limits,
                                       page_table).cpu().numpy()
        verify_window = np.concatenate([self._tokens[:, None], proposals],
                                       axis=1)
        self._run_spec_verify(verify_window, limits, page_table)[0].cpu()

    # -- internals --------------------------------------------------------
    def _dispatch_prefill(self, head: np.ndarray, slot: int,
                          real_len: int) -> None:
        """The whole-prompt prefill through whichever layout this engine
        uses: the slot's page-table row (paged) or its cache row."""
        self.prefills += 1
        if self.paged:
            _paged_prefill_body(self.params, self._operand(head),
                                self._cache,
                                self._operand(self._pool.page_table[slot]),
                                int(real_len), self.config)
        else:
            _prefill_body(self.params, self._operand(head), self._cache,
                          int(slot), int(real_len), self.config)

    def _dispatch_chunk_prefill(self, head: np.ndarray, slot: int,
                                start: int, real_len: int) -> None:
        """One prefill chunk (positions ``start .. start + real_len - 1``)
        through the slot's page-table row."""
        self.prefill_chunks += 1
        _paged_chunk_prefill_body(
            self.params, self._operand(head), self._cache,
            self._operand(self._pool.page_table[slot]), int(start),
            int(real_len), self.config)

    def _run_step(self) -> torch.Tensor:
        self.step_dispatches += 1
        if not self.paged:
            return _step_body(
                self.params, self._operand(self._tokens),
                self._operand(self._positions), self._operand(self._active),
                self._operand(self._temps), self._cache, self._generator,
                self.config, self.top_k)
        page_table = self._pool.page_table
        if self._use_chunk_prefill:
            # a mid-prefill slot's row already points at REAL pages (shared
            # prefix pages above all), but the step writes K/V for every
            # slot at its frozen position: route inactive rows to the trash
            # page in the operand, so that write never lands on a page
            # another sequence reads
            page_table = page_table.copy()
            page_table[~self._active] = TRASH_PAGE
        return _paged_step_body(
            self.params, self._operand(self._tokens),
            self._operand(self._positions), self._operand(self._active),
            self._operand(self._temps), self._operand(page_table),
            self._cache, self._generator, self.config, self.top_k)

    def _admit(self) -> int:
        """Move pending requests into free slots (head of line first; a
        request waits while the pool cannot grant its pages). With the
        prefix cache, the matched prefix pages are granted shared and only
        the suffix is charged; pool pressure first evicts LRU cache-only
        pages."""
        joined = 0
        while True:
            with self._lock:
                self._drop_cancelled_pending_locked()
                free = next((index for index, slot
                             in enumerate(self._slots) if slot is None), None)
                if free is None or not self._pending:
                    return joined
                request = self._pending[0]
                cached_tokens = 0
                if self.paged:
                    needed = self._pool.pages_for(
                        len(request.prompt) + request.max_new_tokens)
                    if self._prefix is not None:
                        cached_tokens, shared = self._prefix.match(
                            request.prompt)
                        fresh = needed - len(shared)
                        shortfall = fresh - self._pool.free_pages
                        if shortfall > 0:
                            self._prefix.evict(shortfall)
                        granted = self._pool.assign_shared(free, shared,
                                                           fresh)
                    else:
                        granted = self._pool.assign(free, needed)
                    if not granted:
                        # strict FIFO: smaller requests never overtake, so
                        # long ones cannot starve (submit() rejected the
                        # impossible)
                        return joined
                    if self._prefix is not None:
                        if cached_tokens > 0:
                            self.prefix_hits += 1
                        else:
                            self.prefix_misses += 1
                # last legal write position of the speculative windows
                self._pos_limits[free] = (len(request.prompt)
                                          + request.max_new_tokens - 1)
                self._pending.popleft()
                self._slots[free] = _Slot(request=request,
                                          joined_ts=time.monotonic(),
                                          cached_tokens=cached_tokens)
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
        """Prefill the prompt head (all but the last token) into the slot
        and arm its per-slot state; the next decode step consumes the last
        prompt token and emits the first generated one.

        A prefix-cache engine SCHEDULES the prefill instead: the slot
        starts parked (inactive, its row sent to the trash page in the step
        operand) at the first uncached position, and
        :meth:`_advance_prefills` — in this same tick — dispatches one
        chunk per tick until the slot arms. A full-prefix hit arms at once,
        with zero chunks."""
        prompt = request.prompt
        prompt_len = len(prompt)
        if self._use_chunk_prefill:
            state = self._slots[slot]
            state.prefill_target = prompt_len - 1
            state.prefill_next = min(state.cached_tokens,
                                     state.prefill_target)
            state.prefill_done = False
            state.prefill_started_ts = time.monotonic()
            if state.prefill_next >= state.prefill_target:
                self._finish_prefill(slot, state)
            return
        if prompt_len > 1:
            width = _prefill_bucket(prompt_len - 1, self.max_len - 1)
            head = np.zeros((1, width), np.int32)
            head[0, :prompt_len - 1] = prompt[:-1]
            try:
                self._dispatch_prefill(head, slot, prompt_len - 1)
                if self._spec is not None:
                    # the same head into the draft lane's K/V
                    self._spec.prefill(head, slot, prompt_len - 1)
            except Exception:
                # a failed prefill must not wedge the slot: free it and
                # requeue the request at the head before re-raising
                with self._lock:
                    if (self._slots[slot] is not None
                            and self._slots[slot].request is request):
                        self._free_slot_locked(slot)
                    self._pending.appendleft(request)
                raise
        with self._lock:
            self._tokens[slot] = prompt[-1]
            self._positions[slot] = prompt_len - 1
            self._temps[slot] = request.temperature
            self._active[slot] = True
            # the draft's first catch-up window: just the current token
            self._spec_windows[slot] = [int(prompt[-1])]

    def _advance_prefills(self) -> int:
        """Dispatch ONE prefill chunk for every slot still mid-prefill. A
        cancel is honored here too, so a cancel mid-chunk frees the slot
        (and its net-releasable pages) without arming it. Returns the
        chunks dispatched."""
        if not self._use_chunk_prefill:
            return 0    # whole prompts are prefilled inside _join
        with self._lock:
            pending = [(index, slot) for index, slot in enumerate(self._slots)
                       if slot is not None and not slot.prefill_done]
        chunks = 0
        for index, state in pending:
            if state.request.cancelled:
                with self._lock:
                    if self._slots[index] is state:
                        self._free_slot_locked(index)
                        self._finish_locked(state.request,
                                            outcome="cancelled")
                continue
            self._advance_prefill_slot(index, state)
            chunks += 1
        return chunks

    def _advance_prefill_slot(self, index: int, state: _Slot) -> None:
        """One chunk of ``state``'s prompt: positions ``prefill_next ..
        prefill_next + chunk - 1``, width bucketed. The pages wholly covered
        by dispatched chunks enter the radix tree right away: every later
        reader is dispatched after this chunk, in stream order."""
        request = state.request
        prompt = request.prompt
        start = state.prefill_next
        remaining = state.prefill_target - start
        length = min(remaining, self.prefill_chunk_tokens or remaining)
        width = _prefill_bucket(length, self.max_len - 1)
        head = np.zeros((1, width), np.int32)
        head[0, :length] = prompt[start:start + length]
        started = time.monotonic()
        self._dispatch_chunk_prefill(head, index, start, length)
        if self._spec is not None:
            # into the draft lane BEFORE the radix tree adopts the chunk's
            # pages: a cached page carries both lanes' K/V
            self._spec.chunk_prefill(head, index, start, length)
        state.prefill_ms += (time.monotonic() - started) * 1e3
        state.prefill_chunks += 1
        state.prefill_next = start + length
        with self._lock:
            if self._slots[index] is state:
                self._prefix.insert(prompt, self._pool.page_table[index],
                                    state.prefill_next)
        if state.prefill_next >= state.prefill_target:
            self._finish_prefill(index, state)

    def _finish_prefill(self, index: int, state: _Slot) -> None:
        """Arm a slot whose prefill (possibly zero chunks — a full-prefix
        hit) is dispatched: the next decode step emits its first token."""
        request = state.request
        with self._lock:
            if self._slots[index] is not state:
                return                       # cancelled and freed meanwhile
            if request.cancelled:
                self._free_slot_locked(index)
                self._finish_locked(request, outcome="cancelled")
                return
            state.prefill_done = True
            self._tokens[index] = request.prompt[-1]
            self._positions[index] = state.prefill_target
            self._temps[index] = request.temperature
            self._active[index] = True
            self._spec_windows[index] = [int(request.prompt[-1])]

    # -- speculative tick --------------------------------------------------
    def _spec_operands_locked(self):
        """Host operands of the two speculative dispatches: the
        right-aligned catch-up window (tokens accepted since the draft last
        ran, ending at each slot's current token) and its lengths, the
        per-slot write limits and — paged — the page table with inactive
        rows sent to the trash page (a parked or freed slot's speculative
        writes never land on a real or shared page)."""
        width = self.spec_tokens + 1
        window = np.zeros((self.capacity, width), np.int32)
        lens = np.zeros(self.capacity, np.int32)
        for index in range(self.capacity):
            if not self._active[index]:
                continue
            tokens = (self._spec_windows[index]
                      or [int(self._tokens[index])])[-width:]
            lens[index] = len(tokens)
            window[index, width - len(tokens):] = tokens
        limits = self._pos_limits.copy()
        page_table = None
        if self.paged:
            page_table = self._pool.page_table.copy()
            page_table[~self._active] = TRASH_PAGE
        return window, lens, limits, page_table

    def _run_spec_verify(self, verify_window: np.ndarray, limits: np.ndarray,
                         page_table: Optional[np.ndarray]):
        """The batched target verify over ``[S, k+1]`` window tokens
        (current token + proposals): ``(greedy [S, k+1], chosen [S])`` on
        the device."""
        self.step_dispatches += 1
        operands = (self._operand(verify_window),
                    self._operand(self._positions),
                    self._operand(self._active), self._operand(self._temps),
                    self._operand(limits))
        if self.paged:
            return _paged_spec_verify_body(
                self.params, *operands, self._operand(page_table),
                self._cache, self._generator, self.config, self.top_k)
        return _spec_verify_body(self.params, *operands, self._cache,
                                 self._generator, self.config, self.top_k)

    def _spec_decode_step(self) -> int:
        """One speculative tick: draft catch-up + k proposals, ONE batched
        verify over all k+1 positions, then longest-matching-prefix
        acceptance. Greedy slots emit the target's own greedy tokens (the
        matched proposals and the bonus token: what k+1 plain steps would
        emit); sampled slots emit the verify pass's one ``_choose_next``
        token. Rollback is not advancing past the last accepted token:
        rejected positions hold stale K/V that the next tick overwrites
        before anything attends them, in both lanes."""
        with self._lock:
            stepped = [(index, slot.request)
                       for index, slot in enumerate(self._slots)
                       if slot is not None and bool(self._active[index])]
            if not stepped:
                return 0
            window, lens, limits, page_table = self._spec_operands_locked()
        proposals = np.asarray(self._spec.propose(
            window, lens, self._positions, limits, page_table).cpu())
        verify_window = np.concatenate([self._tokens[:, None], proposals],
                                       axis=1)
        greedy, chosen = self._run_spec_verify(verify_window, limits,
                                               page_table)
        greedy, chosen = greedy.cpu().numpy(), chosen.cpu().numpy()
        now = time.monotonic()
        with self._lock:
            self.steps += 1
            for index, request in stepped:
                if (self._slots[index] is None
                        or self._slots[index].request is not request):
                    continue        # freed between snapshot and apply
                if self._temps[index] > 0.0:
                    # sampled slots don't speculate: one token per tick,
                    # proposals discarded and not counted
                    emitted = [int(chosen[index])]
                else:
                    matched = 0
                    while (matched < self.spec_tokens
                           and int(proposals[index, matched])
                           == int(greedy[index, matched])):
                        matched += 1
                    emitted = [int(greedy[index, j])
                               for j in range(matched + 1)]
                    self.spec_proposed += self.spec_tokens
                    self.spec_accepted += matched
                consumed: List[int] = []
                for token in emitted:
                    # EOS inside the accepted run, the budget and a pending
                    # cancel truncate here, token by token, through the
                    # plain step's own bookkeeping
                    self._tokens[index] = token
                    self._positions[index] += 1
                    self._apply_token_locked(index, request, token, now)
                    consumed.append(token)
                    if self._slots[index] is None or request.finished:
                        break
                if (self._slots[index] is not None
                        and self._slots[index].request is request):
                    # next tick's catch-up window = what was accepted
                    self._spec_windows[index] = consumed
        return len(stepped)

    def _decode_step(self) -> int:
        if self._spec is not None:
            return self._spec_decode_step()
        with self._lock:
            # slots still chunk-prefilling are parked (active False): they
            # join the batch only once armed
            stepped = [(index, slot.request)
                       for index, slot in enumerate(self._slots)
                       if slot is not None and bool(self._active[index])]
        if not stepped:
            return 0
        emitted = self._run_step().cpu().numpy()
        now = time.monotonic()
        with self._lock:
            self.steps += 1
            for index, request in stepped:
                if (self._slots[index] is None
                        or self._slots[index].request is not request):
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
        """Free the slot. Paged: release its grant NOW through the
        refcounted pool (pages still shared with other slots or held by the
        prefix cache survive; the rest may be reassigned on the next
        admission), so the row points back at the trash page and the
        position resets to 0 — the parked slot's writes land at (trash,
        0). Contiguous: the position stays frozen, so the parked slot's
        writes keep landing on one consumed cell of its own row."""
        self._slots[index] = None
        self._active[index] = False
        self._spec_windows[index] = []
        # speculative writes to a freed slot must not land (the contiguous
        # layout keeps its position frozen: the limit is its only guard)
        self._pos_limits[index] = -1
        if self.paged:
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
        return sum(1 for slot in self._slots if slot is not None)

    def stats(self) -> Dict:
        """Engine snapshot: a subset of the JAX engine's ``stats``, under
        the same key names. Not here yet: the mesh keys (``meshShape``,
        ``numDevices``), the host tier's (``hostKvBytes``,
        ``hostPagesResident``, ``hostBytesUsed``, ``hostHitRate``),
        ``busySlotSeconds`` and the latency quantiles (``ttftP50Ms``,
        ``ttftP95Ms``, ``intertokenP50Ms``, ``intertokenP95Ms``). ``device``,
        ``stepDispatches`` and ``prefills`` are the port's own."""
        with self._lock:
            lookups = self.prefix_hits + self.prefix_misses
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
                "kvPagesTotal": (self._pool.num_pages if self.paged
                                 else None),
                "kvPagesFree": (self._pool.free_pages if self.paged
                                else None),
                "kvQuant": self.kv_quant,
                "kvBytesPerToken": (
                    round(self._page_bytes / self.page_size, 1)
                    if self.paged else None),
                "prefixCache": self.prefix_cache,
                "prefixHits": self.prefix_hits,
                "prefixMisses": self.prefix_misses,
                "prefixHitRate": (round(self.prefix_hits / lookups, 4)
                                  if lookups else None),
                "cachedPages": (self._prefix.cached_pages
                                if self._prefix is not None else None),
                "prefillChunkTokens": (self.prefill_chunk_tokens
                                       if self._use_chunk_prefill else None),
                "speculative": self.speculative,
                "specTokens": (self.spec_tokens if self._spec is not None
                               else None),
                "specProposed": self.spec_proposed,
                "specAccepted": self.spec_accepted,
                "specAcceptanceRate": (
                    round(self.spec_accepted / self.spec_proposed, 4)
                    if self.spec_proposed else None),
                "requestsCompleted": self.completed_requests,
                "tokensEmitted": self.emitted_tokens,
                "steps": self.steps,
                "stepDispatches": self.step_dispatches,
                "prefills": self.prefills,
            }

    def spec_acceptance_rate(self,
                             min_proposed: int = 64) -> Optional[float]:
        """Lifetime draft-token acceptance rate: None while the lane is off
        or fewer than ``min_proposed`` tokens have been proposed."""
        if self._spec is None:
            return None
        with self._lock:
            if self.spec_proposed < min_proposed:
                return None
            return self.spec_accepted / self.spec_proposed
