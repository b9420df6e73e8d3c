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
* **The step graph** (``step_graph.py``): on the card, without a serving
  mesh and with the speculative lane off, the decode step is captured once
  as a CUDA graph (at warmup's step, or the first step of an engine that
  never warmed up) and replayed every tick over static device operands,
  each filled by a non-blocking copy from pinned memory. The graph holds
  the same body and draws from the same registered generator, so its
  tokens are the eager step's bit for bit; the host then waits on the card
  instead of enqueueing its launches one by one. Prefills and chunks stay
  eager, and so does an engine left at ``speculative="auto"``, which turns
  the lane on on the card, and every step while a device profile is
  captured (``observability/profiling.py``), so that the trace holds the
  step's kernels.
* **Speculative decoding** (``speculative``; ``auto`` = on where the
  engine runs on the card, off on the CPU): a draft model
  (``speculative.py``) proposes ``spec_tokens`` tokens per slot, one
  batched target pass verifies them and the longest matching prefix is
  accepted, so greedy output equals the plain step's. Every prefill is
  mirrored into the draft lane; each tick is one propose and one verify
  instead of the plain step.

* **KV-page tiering** (``host_kv_bytes`` > 0; paged int8 with the prefix
  cache). Pages the radix tree evicts, and a leaving slot's prefix pages
  no one else holds, are gathered on the compute stream (in stream order
  ahead of any later write to the recycled page) and copied to a bounded
  host-RAM store (``paging.HostPageStore``, LRU in a byte budget). A later
  prompt whose prefix continues past the device match into resident
  pages is granted fresh pages as usual, parks, and has the run PROMOTED:
  the copy lane assembles it and copies it up, then the pump injects it
  and resumes prefill past it. On the card both copies run on a copy
  stream of their own, through pinned host buffers, and a lane thread
  waits on them, so the pump never waits on a copy; only the run's real
  pages cross the link (JAX pads both ways to a fixed width).
* **Deadlines, Retry-After and the fault plan** (the data-plane guards):
  a request past its ``deadline_s`` ends ``timeout`` in the queue,
  mid-prefill or mid-decode; the admission errors quote a Retry-After
  estimated from the observed inter-token p50 and the page walk; a
  :class:`~.faults.ServingFaultPlan` is consulted before every dispatch,
  ahead of its first write to the cache. Every bookkeeping timestamp reads
  the injectable ``clock``.
* **Observability**, as in JAX: the ``tpuhive_generate_*`` families of the
  process-wide registry, a request-ledger row per request (rejections
  included) stamped phase by phase, queue/prefill/decode spans keyed by
  the row's request id, and, where installed, the tenant meter (charged
  each tick from one clock sample) and the flight recorder (each
  ``step()`` stamped in a ``finally``). With ``flight_recorder=None`` and
  ``tenant_meter=None`` the tick does the same device work as without
  them. The port compiles nothing per shape and builds its kernels once,
  so the rows' ``prefillCompile`` read ``"hit"`` and the ticks'
  ``compiles`` 0 — what a warm JAX engine records.

* **The serving mesh** (``mesh``: a ``parallel.mesh.ServingMesh`` of dp x
  tp ranks over ``torch.distributed``). JAX shards one controller's arrays
  with GSPMD; here every rank is a process. Rank 0 runs this engine as
  always — queue, pool, prefix cache, ledger, sampling — and, before each
  device body, broadcasts the body's operands; the workers
  (``mesh_worker.serve_worker``) run the same body on their shards. Each
  rank holds the tp_rank-th block of every tp-sharded weight axis
  (``shard_serving_params``), computes its local heads — K1 and K8/K9
  launch at the local head counts — and sums the row-parallel products
  over its tp replica (``TensorParallel``); under the GQA guard (tp not
  dividing the K/V heads) K/V and the cache stay whole and the attention
  kernels run on every head. Pages are whole on every rank (JAX's kernel
  route: page tables hold global ids), so a dp replica computes what the
  others do; ``slots`` and ``kv_pages`` count per engine (``build_engine``
  multiplies the per-replica knobs by dp). The speculative lane runs on
  every rank: each holds its shard of the draft by the draft's own rules
  and its KV heads of the draft lane, the prefill mirrors ride the
  prefill and chunk commands, and each tick sends ``PROPOSE`` and
  ``VERIFY``; only rank 0 samples and accepts. The host tier keeps ONE
  index, rank 0's ``HostPageStore`` (keys, LRU, budget and counters, on
  whole-page bytes as JAX counts them), while each rank keeps the payload
  of its own cache shard in its own host RAM under the entry id rank 0
  assigned: ``EXTRACT`` gathers a demotion's pages on every rank and each
  rank's copy lane brings its shard down, ``INJECT`` has each rank stage
  and scatter its shard of a promotion, ``DROP`` forgets what rank 0's
  store let go. A rank that lacks a shard at ``INJECT`` says so in the
  command's flag, and rank 0 recomputes the pages (a fallback, not a
  fault).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import queue as queue_module
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..parallel.mesh import (
    ServingMesh,
    TensorParallel,
    kernel_cache_spec,
    local_shape,
    shard_model,
)
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
from ..ops import cuda_build
from ..ops import kv_quant as kvq
from ..ops.flash_attention import NEG_INF, flash_attention
from ..ops.paged_attention import (
    decode_attention,
    paged_attention,
    resolve_paged_kernel,
)
from ..observability import (
    Histogram,
    get_registry,
    get_request_ledger,
    get_tracer,
)
from ..observability.accounting import ANONYMOUS_TENANT
from ..observability.profiling import capture_in_flight
from . import EngineDrainingError, QueueFullError, RateLimitError
from .faults import ServingFaultPlan
from .flight_recorder import TickMarks
from .mesh_worker import (
    OP_BUILD,
    OP_CHUNK,
    OP_DROP,
    OP_EXTRACT,
    OP_INJECT,
    OP_PING,
    OP_PREFILL,
    OP_PROPOSE,
    OP_RELEASE,
    OP_STEP,
    OP_VERIFY,
    TP_BODIES,
    MeshWorkerError,
    finish_command,
    ids_to_words,
    send_command,
    stop_workers,
    words_to_ids,
)
from .paging import (
    TRASH_PAGE,
    HostCopyLane,
    HostPageEntry,
    HostPageStore,
    LaneJob,
    PagePool,
    page_content_key,
)
from .prefix_cache import PrefixCache
from .speculative import (
    SpeculativeLane,
    _paged_spec_verify_body,
    _spec_verify_body,
    build_draft,
    resolve_speculative,
)
from .step_graph import StepGraph, graphs_the_step

# -- metrics (registered once at import; one exposition surface) -------------
_REQUESTS = get_registry().counter(
    "tpuhive_generate_requests_total",
    "Generation requests by outcome: completed, rejected_queue, "
    "rejected_ratelimit, cancelled, timeout, failed.",
    labels=("outcome",))
_TOKENS = get_registry().counter(
    "tpuhive_generate_tokens_total",
    "Tokens emitted by the serving engine across all requests.")
_QUEUE_DEPTH = get_registry().gauge(
    "tpuhive_generate_queue_depth",
    "Requests waiting for a slot (admission queue occupancy).")
_QUEUE_CAPACITY = get_registry().gauge(
    "tpuhive_generate_queue_capacity",
    "Bound of the admission queue — depth/capacity == 1 is saturation.")
_SLOTS_BUSY = get_registry().gauge(
    "tpuhive_generate_slots_busy",
    "Slots currently occupied by a running sequence.")
_SLOTS_TOTAL = get_registry().gauge(
    "tpuhive_generate_slots_total",
    "Slot-pool capacity (the fixed decode batch size).")
_TTFT_SECONDS = get_registry().histogram(
    "tpuhive_generate_ttft_seconds",
    "Submit-to-first-token latency (queue wait + prefill + first step).")
_QUEUE_WAIT_SECONDS = get_registry().histogram(
    "tpuhive_generate_queue_wait_seconds",
    "Submit-to-slot-join latency: the admission-queue share of TTFT, "
    "separated so queue pressure and prefill cost are tunable apart "
    "(docs/OBSERVABILITY.md 'Request tracing & profiling').")
_INTERTOKEN_SECONDS = get_registry().histogram(
    "tpuhive_generate_intertoken_seconds",
    "Gap between consecutive emitted tokens of one sequence.")
_BATCH_EFFICIENCY = get_registry().histogram(
    "tpuhive_generate_batch_efficiency",
    "Active slots / capacity per decode step (1.0 = perfectly packed).",
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
_KV_PAGES_FREE = get_registry().gauge(
    "tpuhive_generate_kv_pages_free",
    "Free KV-cache pages in the paged engine's pool (0 = admission is "
    "page-bound; the kv_pages_exhausted alert signal).")
_KV_PAGES_TOTAL = get_registry().gauge(
    "tpuhive_generate_kv_pages_total",
    "Usable KV-cache pages in the paged engine's pool (excludes the trash "
    "page parked slots write into).")
_SLOT_PAGES = get_registry().gauge(
    "tpuhive_generate_slot_kv_pages",
    "KV pages currently owned by each slot (0 when free or contiguous).",
    labels=("slot",))
_KV_BYTES_CAPACITY = get_registry().gauge(
    "tpuhive_generate_kv_bytes_capacity",
    "KV-cache HBM the paged pool can hold across all layers (payload + "
    "int8 scale side-arrays when kv_quant is on) — with _used, the "
    "bytes-level view of the int8 capacity doubling (docs/SERVING.md "
    "'Quantized KV pages').")
_KV_BYTES_USED = get_registry().gauge(
    "tpuhive_generate_kv_bytes_used",
    "KV-cache HBM currently backing granted pages across all layers — "
    "used/capacity is the byte-level pool fill the kv_quant sizing "
    "story is measured in.")
_MESH_DEVICES = get_registry().gauge(
    "tpuhive_generate_mesh_devices",
    "Devices in the serving mesh (dp x tp; 1 = single-chip engine).")
_PREFIX_HITS = get_registry().counter(
    "tpuhive_generate_prefix_hits_total",
    "Admitted requests whose prompt matched cached prefix pages (>= "
    "prefix_min_tokens skipped at prefill; docs/SERVING.md 'Prefix "
    "cache & chunked prefill').")
_PREFIX_MISSES = get_registry().counter(
    "tpuhive_generate_prefix_misses_total",
    "Admitted requests that paid a full private prefill (no usable "
    "cached prefix).")
_PREFIX_CACHED_PAGES = get_registry().gauge(
    "tpuhive_generate_prefix_cached_pages",
    "KV pages currently retained by the radix prefix cache (evictable "
    "under pool pressure once no slot shares them).")
_PREFIX_EVICTIONS = get_registry().counter(
    "tpuhive_generate_prefix_evictions_total",
    "Prefix-cache pages evicted under pool pressure — fast growth is the "
    "prefix_cache_thrash alert signal (docs/OBSERVABILITY.md).")
_PREFILL_CHUNKS = get_registry().histogram(
    "tpuhive_generate_prefill_chunks",
    "Prefill chunks dispatched per admitted request (0 = full prefix hit; "
    "long prompts split across scheduler ticks so decode latency stays "
    "flat — docs/SERVING.md 'Prefix cache & chunked prefill').",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))
_SPEC_PROPOSED = get_registry().counter(
    "tpuhive_generate_spec_proposed_total",
    "Draft tokens proposed to the speculative verify pass (greedy slots "
    "only; docs/SERVING.md 'Speculative decoding').")
_SPEC_ACCEPTED = get_registry().counter(
    "tpuhive_generate_spec_accepted_total",
    "Draft tokens the target's batched verify accepted — "
    "accepted/proposed is the acceptance rate the spec_acceptance_low "
    "alert watches.")
_DEADLINE_TIMEOUTS = get_registry().counter(
    "tpuhive_generate_deadline_timeouts_total",
    "Requests whose per-request deadline expired, by phase: queue (never "
    "reached a slot), prefill (mid-chunk), decode (truncated mid-"
    "generation). Every timeout still ends its stream with a terminal "
    "chunk (docs/ROBUSTNESS.md 'Serving data plane').",
    labels=("phase",))
_HOST_KV_HITS = get_registry().counter(
    "tpuhive_generate_host_kv_hits_total",
    "Admitted requests whose prompt extended past the device-cached "
    "prefix into host-resident pages (>= 1 page promoted by DMA instead "
    "of recomputed; docs/SERVING.md 'KV-page tiering').")
_HOST_KV_MISSES = get_registry().counter(
    "tpuhive_generate_host_kv_misses_total",
    "Tier-on admissions the host store could not extend (no resident "
    "continuation past the device match) — hits/(hits+misses) is the "
    "host hit rate.")
_HOST_KV_DEMOTIONS = get_registry().counter(
    "tpuhive_generate_host_kv_demotions_total",
    "KV pages demoted (spilled) to the host-RAM store when the radix "
    "tree evicted them or their slot drained — sustained fast growth is "
    "the host_kv_thrash alert signal (docs/OBSERVABILITY.md).")
_HOST_KV_PROMOTIONS = get_registry().counter(
    "tpuhive_generate_host_kv_promotions_total",
    "KV pages promoted from the host store back into fresh device pages "
    "on a radix continuation hit (async copy lane; never blocks the "
    "pump).")
_HOST_KV_BYTES_USED = get_registry().gauge(
    "tpuhive_generate_host_kv_bytes_used",
    "Host RAM currently held by demoted int8 page payloads + scales.")
_HOST_KV_BYTES_CAPACITY = get_registry().gauge(
    "tpuhive_generate_host_kv_bytes_capacity",
    "Byte budget of the host page store ([generation_service] "
    "host_kv_bytes; 0 = tiering off).")

log = logging.getLogger(__name__)

#: the ledger's compile event for every prefill: the port compiles nothing
#: per shape and builds its kernels once, which a warm JAX engine records as
#: a "hit"
_COMPILE_EVENT = "hit"


# -- device functions ---------------------------------------------------------

def _embed(params: Params, tokens: torch.Tensor,
           tp: Optional[TensorParallel]) -> torch.Tensor:
    """Embedding rows of ``tokens``; a vocab-sharded table is read by the
    mesh's masked gather and sum."""
    if tp is None:
        return params["tok_embed"][tokens.long()]
    return tp.embed(params["tok_embed"], tokens)


def _reducers(tp: Optional[TensorParallel]) -> Dict[str, object]:
    """``block_forward``'s row-parallel sums (none without a mesh)."""
    if tp is None:
        return {}
    return {"reduce_attn": tp.reduce_attn, "reduce_mlp": tp.reduce_mlp}


def _on_heads(tp: Optional[TensorParallel], q: torch.Tensor,
              attention: Callable[[torch.Tensor], torch.Tensor]
              ) -> torch.Tensor:
    """``attention(q)`` on this rank's heads (all heads under the GQA
    guard, cut back to this rank's)."""
    return attention(q) if tp is None else tp.attend(q, attention)


def _choose_next(params: Params, x: torch.Tensor, tokens: torch.Tensor,
                 active: torch.Tensor, temps: torch.Tensor,
                 generator: Optional[torch.Generator],
                 config: TransformerConfig, top_k: Optional[int],
                 tp: Optional[TensorParallel] = None
                 ) -> Optional[torch.Tensor]:
    """Shared step tail: final norm -> f32 logits -> per-slot greedy or
    sampled choice (Gumbel-max from the engine's generator). Parked slots
    keep their token. Under a mesh the vocab-sharded logits are assembled
    over tp, and only the controller (the rank with a ``generator``)
    chooses: a worker returns None."""
    x = _rmsnorm(x, params["final_norm"]["scale"])
    logits = _lm_head(x[:, 0], params["w_lm_head"], config.dtype)  # [S, V]
    if tp is not None:
        logits = tp.logits(logits)
    if generator is None:
        return None
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
               generator: Optional[torch.Generator],
               config: TransformerConfig, top_k: Optional[int],
               tp: Optional[TensorParallel] = None
               ) -> Optional[torch.Tensor]:
    """One decode step over the CONTIGUOUS cache for the whole slot batch:
    each slot consumes the token AT its position, writes that position's
    K/V into its own row ``(layer, slot, position)`` in place, attends its
    row masked to ``key <= position`` (the plain masked decode attention,
    positions broadcast per slot) and returns the token for position + 1."""
    x = _embed(params, tokens, tp)[:, None, :]                    # [S,1,D]
    rope_positions = positions[:, None]                           # [S,1]
    slot_ids = torch.arange(tokens.shape[0], device=tokens.device)
    write_positions = positions.long()

    def attend(q, k, v, layer):
        cache.k[layer][slot_ids, write_positions] = k[:, 0].to(cache.k.dtype)
        cache.v[layer][slot_ids, write_positions] = v[:, 0].to(cache.v.dtype)
        return _on_heads(tp, q, lambda q: decode_attention(
            q, cache.k[layer], cache.v[layer],
            positions[:, None, None, None, None]))

    for layer_index, block in enumerate(params["blocks"]):
        x = TransformerLM.block_forward(x, block, config, rope_positions,
                                        attend, layer_index=layer_index,
                                        **_reducers(tp))
    return _choose_next(params, x, tokens, active, temps, generator, config,
                        top_k, tp)


def _paged_step_body(params: Params, tokens: torch.Tensor,
                     positions: torch.Tensor, active: torch.Tensor,
                     temps: torch.Tensor, page_tables: torch.Tensor,
                     cache, generator: Optional[torch.Generator],
                     config: TransformerConfig,
                     top_k: Optional[int],
                     tp: Optional[TensorParallel] = None
                     ) -> Optional[torch.Tensor]:
    """One decode step over the paged cache for the whole slot batch:
    each slot consumes the token AT its position, writes that position's
    K/V to ``(page_tables[s, pos // page_size], pos % page_size)`` in place
    (quantizing onto the page's running-max scale under int8), attends
    through the page table and returns the token for position + 1."""
    x = _embed(params, tokens, tp)[:, None, :]                    # [S,1,D]
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
        return _on_heads(tp, q, lambda q: paged_attention(
            q, cache.k[layer], cache.v[layer], page_tables, positions,
            k_scales=cache.k_scale[layer] if quant else None,
            v_scales=cache.v_scale[layer] if quant else None))

    for layer_index, block in enumerate(params["blocks"]):
        x = TransformerLM.block_forward(x, block, config, rope_positions,
                                        attend, layer_index=layer_index,
                                        **_reducers(tp))
    return _choose_next(params, x, tokens, active, temps, generator, config,
                        top_k, tp)


def _paged_prefill_body(params: Params, head: torch.Tensor, cache,
                        page_table_row: torch.Tensor, real_len: int,
                        config: TransformerConfig,
                        tp: Optional[TensorParallel] = None) -> None:
    """Prefill one joining sequence's prompt head through its page table.
    ``head`` [1, W] is padded to a bucket; prompt position ``w < real_len``
    writes to ``(page_table_row[w // page_size], w % page_size)``. Padded
    positions write NOTHING — not even to the trash page — and the decode
    steps rewrite every later position before first attending it."""
    batch, width = head.shape
    x = _embed(params, head, tp)
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
        return _on_heads(tp, q,
                         lambda q: flash_attention(q, k, v, causal=True))

    for layer_index, block in enumerate(params["blocks"]):
        x = TransformerLM.block_forward(x, block, config, positions, attend,
                                        layer_index=layer_index,
                                        **_reducers(tp))


def _prefill_body(params: Params, head: torch.Tensor, cache: KVCache,
                  slot: int, real_len: int,
                  config: TransformerConfig,
                  tp: Optional[TensorParallel] = None) -> None:
    """Prefill one joining sequence's prompt head into its CONTIGUOUS slot
    row: ``head`` [1, W] is padded to a bucket, positions ``w < real_len``
    write their K/V to ``(layer, slot, w)`` and padded positions write
    zeros; the prompt attends itself through the flash-forward kernel."""
    batch, width = head.shape
    x = _embed(params, head, tp)
    positions = torch.arange(width, dtype=torch.int32,
                             device=head.device).expand(batch, width)
    valid = (torch.arange(width, device=head.device)
             < real_len)[None, :, None, None]

    def attend(q, k, v, layer):
        cache.k[layer, slot, :width] = torch.where(valid, k, 0)[0].to(
            cache.k.dtype)
        cache.v[layer, slot, :width] = torch.where(valid, v, 0)[0].to(
            cache.v.dtype)
        return _on_heads(tp, q,
                         lambda q: flash_attention(q, k, v, causal=True))

    for layer_index, block in enumerate(params["blocks"]):
        x = TransformerLM.block_forward(x, block, config, positions, attend,
                                        layer_index=layer_index,
                                        **_reducers(tp))


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
                              config: TransformerConfig,
                              tp: Optional[TensorParallel] = None) -> None:
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
    x = _embed(params, head, tp)
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
            return _on_heads(tp, q, lambda q: _chunk_attend(
                q, ctx_k[0], ctx_v[0], global_positions))
        cache.k[layer][pages, page_offsets] = k[0, :real_len].to(
            cache.k.dtype)
        cache.v[layer][pages, page_offsets] = v[0, :real_len].to(
            cache.v.dtype)
        # gather AFTER the writes: within-chunk causality comes from the
        # positional mask, as in the decode step's write-then-attend
        ctx_k = cache.k[layer][row].reshape(window, *cache.k.shape[3:])
        ctx_v = cache.v[layer][row].reshape(window, *cache.v.shape[3:])
        return _on_heads(tp, q, lambda q: _chunk_attend(
            q, ctx_k, ctx_v, global_positions))

    for layer_index, block in enumerate(params["blocks"]):
        x = TransformerLM.block_forward(x, block, config, positions, attend,
                                        layer_index=layer_index,
                                        **_reducers(tp))


def _page_extract_body(cache: QuantKVCache, page_ids: torch.Tensor
                       ) -> Tuple[torch.Tensor, ...]:
    """Gather whole int8 pages + their scale rows out of the paged cache
    for DEMOTION to the host tier: ``(k, k_scale, v, v_scale)``, fresh
    tensors ``[L, n, ...]``. A pure read. JAX's donated-buffer chain
    orders it before any overwriting prefill; here stream order does: it
    is enqueued on the compute stream before any later write to the
    gathered pages, so it reads the bytes as they were."""
    k, k_scale = kvq.extract_pages(cache.k, cache.k_scale, page_ids)
    v, v_scale = kvq.extract_pages(cache.v, cache.v_scale, page_ids)
    return k, k_scale, v, v_scale


def _page_inject_body(cache: QuantKVCache, page_ids: torch.Tensor,
                      k: torch.Tensor, k_scale: torch.Tensor,
                      v: torch.Tensor, v_scale: torch.Tensor) -> None:
    """Scatter host-staged int8 pages + scales into freshly granted
    physical pages, in place: the device half of PROMOTION. A host round
    trip is byte-exact: payload and scales come back untouched, with no
    requantization either way."""
    kvq.inject_pages(cache.k, cache.k_scale, page_ids, k, k_scale)
    kvq.inject_pages(cache.v, cache.v_scale, page_ids, v, v_scale)


# -- host side ----------------------------------------------------------------

#: handle event kinds
TOKEN, DONE, ERROR = "token", "done", "error"

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
        ``TimeoutError`` when nothing arrives for ``timeout_s`` and
        ``RuntimeError`` when the engine failed the request."""
        while True:
            try:
                kind, payload = self._events.get(timeout=timeout_s)
            except queue_module.Empty:
                self.cancel()
                raise TimeoutError(
                    f"no token within {timeout_s:.0f}s") from None
            if kind == TOKEN:
                yield payload
            elif kind == DONE:
                self._summary = payload
                return
            else:
                raise RuntimeError(str(payload))

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
    #: wall-clock anchor of the submitted_ts engine-clock stamp: spans and
    #: ledger rows translate engine-clock offsets onto it, so fake clocks
    #: stay exact while readers still get unix timestamps
    submitted_wall: float = 0.0
    record: Optional[object] = None          # observability RequestRecord
    handle: Optional[GenerationHandle] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    first_token_ts: Optional[float] = None
    last_token_ts: Optional[float] = None
    #: engine-clock stamp past which the request times out (queue, prefill
    #: or mid-decode); None = no deadline
    deadline_ts: Optional[float] = None
    cancelled: bool = False
    finished: bool = False
    #: the tenant meter's resource-time integrals for this request,
    #: finalized onto the ledger row at finish (0.0 without a meter)
    device_seconds: float = 0.0
    kv_byte_seconds: float = 0.0

    def wall(self, clock_ts: float) -> float:
        """Translate an engine-clock stamp to wall-clock seconds."""
        return self.submitted_wall + (clock_ts - self.submitted_ts)


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
    prefill_compile: Optional[str] = None
    prefill_started_ts: float = 0.0
    # -- host tier ---------------------------------------------------------
    #: pages granted from the host store at admission (0 = no host hit)
    host_hit_pages: int = 0
    #: store entries to promote, handed to the copy lane by _join
    promote_entries: List[HostPageEntry] = dataclasses.field(
        default_factory=list)
    #: physical destination pages: the fresh pages right after the shared
    #: run in this slot's page-table row
    promote_pages: List[int] = dataclasses.field(default_factory=list)
    #: prompt tokens covered once the inject lands; prefill resumes here
    promote_boundary: int = 0
    #: the copy lane's staging job; while set the slot is PARKED like a
    #: slot mid-prefill (out of the decode batch; cancel and deadline
    #: still fire), so a slow copy never stalls the pump
    promote_job: Optional[LaneJob] = None
    promote_started_ts: float = 0.0
    promote_ms: float = 0.0


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
        mesh: Optional[ServingMesh] = None,
        default_deadline_s: float = 0.0,
        max_deadline_s: float = 600.0,
        fault_plan: Optional[ServingFaultPlan] = None,
        clock: Callable[[], float] = time.monotonic,
        flight_recorder=None,
        tenant_meter=None,
        device: DeviceLike = None,
    ) -> None:
        if mesh is not None and device is None:
            device = mesh.device
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
        if default_deadline_s < 0 or max_deadline_s <= 0:
            raise ValueError(
                f"deadlines must be positive (default_deadline_s >= 0), got "
                f"default={default_deadline_s} max={max_deadline_s}")
        if default_deadline_s > max_deadline_s:
            raise ValueError(
                f"default_deadline_s={default_deadline_s} exceeds "
                f"max_deadline_s={max_deadline_s}")
        if mesh is not None:
            if self.device != mesh.device:
                raise ValueError(f"the engine runs on {self.device}, its "
                                 f"serving mesh rank on {mesh.device}")
            if mesh.broken:
                raise MeshWorkerError(
                    f"the serving mesh is broken ({mesh.broken}); restart "
                    "its ranks")
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
        self.clock = clock
        #: per-request wall budget when submit() gets no override; 0 = no
        #: deadline
        self.default_deadline_s = float(default_deadline_s)
        self.max_deadline_s = float(max_deadline_s)
        #: fault-injection seam consulted before every dispatch; None in
        #: production
        self.fault_plan = fault_plan
        #: per-tick black box (serving/flight_recorder.py); None leaves
        #: step() unrecorded
        self.flight_recorder = flight_recorder
        #: (engine clock, wall clock) at the first recorded tick: a tick's
        #: start on the wall clock is read from it, as ``_Request.wall``
        #: reads a request's, so fake clocks stay exact
        self._wall_anchor: Optional[Tuple[float, float]] = None
        #: per-tenant resource-time attribution (observability/
        #: accounting.py), stamped from the pump thread; None keeps every
        #: hook a single attribute check
        self.tenant_meter = tenant_meter
        # -- the serving mesh: mesh=None is the single-device engine. With
        # a mesh this rank keeps its shard of the weights (tp blocks by the
        # GQA-guarded rules) and of the cache, and every dispatch of the
        # controller (rank 0) is mirrored on the workers
        self.mesh = mesh
        self._tp: Optional[TensorParallel] = None
        if mesh is not None:
            self.mesh_dp, self.mesh_tp = mesh.dp, mesh.tp
            self._rules, self.params, self._tp = shard_model(params, config,
                                                             mesh)
        else:
            self.mesh_dp = self.mesh_tp = 1
            self._rules = None
        #: the attention kernels run on this rank's slice of both head
        #: counts (contiguous head blocks keep the kernels' ``h // group``
        #: map aligned); False under the GQA guard, where K/V and the cache
        #: stay whole and the kernels run on every head
        self._kernel_shard_heads = (
            mesh is not None and self._rules.heads == "tp"
            and self._rules.kv_heads == "tp")
        #: the mesh's BUILD count when this engine was built: a dispatch of
        #: an engine the workers no longer hold is refused
        self._mesh_build = None
        #: monotonic stamp of the last command sent (the idle heartbeat)
        self._mesh_last_command = time.monotonic()
        #: ranks that lacked a host shard the last command named
        self._mesh_missing = 0

        self._lock = threading.Lock()
        self._pending: Deque[_Request] = collections.deque()
        #: each slot's request and prefill state (None = free)
        self._slots: List[Optional[_Slot]] = [None] * self.capacity
        self._user_active: Dict[str, int] = {}
        self.completed_requests = 0
        self.emitted_tokens = 0
        self.steps = 0
        #: busy slot-second integral, accumulated from the same dt samples
        #: the tenant meter charges from, so sum(tenant device-seconds) ==
        #: busy_slot_seconds x num_devices exactly; 0.0 without a meter
        self.busy_slot_seconds = 0.0
        self._last_meter_ts: Optional[float] = None
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
        #: private latency views behind ``stats()``'s p50/p95 and the
        #: Retry-After estimate
        self._ttft_hist = Histogram()
        self._intertoken_hist = Histogram()
        self._queue_wait_hist = Histogram()

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
                    num_pages -= num_pages % self.mesh_dp
            if num_pages % self.mesh_dp:
                raise ValueError(
                    f"kv_pages={num_pages} must be divisible by mesh "
                    f"dp={self.mesh_dp} (the page pool shards over dp)")
            # dp reserved trash rows, as in JAX: the same page ids
            self._pool: Optional[PagePool] = PagePool(
                num_pages=num_pages, page_size=self.page_size,
                slots=self.capacity, max_pages_per_slot=max_pages_per_slot,
                trash_pages=self.mesh_dp)
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
            #: one slot's reserved contiguous KV bytes (the whole max_len
            #: row, K+V, all layers): what the tenant meter charges for a
            #: slot's residency when there is no page pool to count
            self._slot_kv_bytes = (
                2 * config.n_layers * self.max_len * config.kv_heads
                * config.d_head
                * torch.empty((), dtype=config.dtype).element_size())
            if self.capacity % self.mesh_dp:
                raise ValueError(
                    f"slots={self.capacity} must be divisible by mesh "
                    f"dp={self.mesh_dp} (the slot pool shards over dp)")
            shape = (config.n_layers, self.capacity, self.max_len,
                     config.kv_heads, config.d_head)
        if mesh is not None:
            # this rank's block: the pool or slot axis whole (JAX's kernel
            # route), the kv-head axis split where both head counts split
            shape = local_shape(shape, kernel_cache_spec(self._rules),
                                mesh.axis_sizes)
        if self._quant:
            scale_shape = (config.n_layers, shape[1], shape[3])
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
        #: sampling runs on the controller only: a worker has no generator
        self._generator = (
            torch.Generator(device=self.device).manual_seed(0)
            if mesh is None or mesh.is_controller else None)

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

        # KV-page tiering: a bounded host-RAM store catches the pages the
        # radix tree would discard and hands them back on the next content
        # hit, refilled by copy instead of recompute. host_kv_bytes=0
        # builds no store, no lane and no copy stream
        self.host_kv_bytes = int(host_kv_bytes)
        self._host_store: Optional[HostPageStore] = None
        self._host_lane: Optional[HostCopyLane] = None
        #: the tier's copies on the card run here, beside the compute
        #: stream (None on the CPU or with the tier off)
        self._copy_stream: Optional[torch.cuda.Stream] = None
        #: pinned host staging for one lane job's pages (k, k_scale, v,
        #: v_scale, flat, max_pages_per_slot pages), pinned once here: the
        #: lane's jobs take turns on it under _staging_lock
        self._staging: Tuple[torch.Tensor, ...] = ()
        self._staging_lock = threading.Lock()
        if self.host_kv_bytes:
            if not (self.paged and self._quant
                    and self._prefix is not None):
                raise ValueError(
                    "host_kv_bytes > 0 needs the paged int8 layout with "
                    "the prefix cache on (pages are the tier unit and the "
                    "radix key is the content identity); set paged=true, "
                    "kv_quant=auto/on, prefix_cache=auto/on — or "
                    "host_kv_bytes=0 to disable tiering")
            self._host_store = HostPageStore(self.host_kv_bytes)
            self._host_lane = HostCopyLane()
            self._prefix.spill = self._spill_page_locked
            if self.device.type == "cuda":
                self._copy_stream = torch.cuda.Stream(self.device)
                # pinning is slow and stalls other CUDA calls of the
                # process, so no job pins memory of its own
                width = self._pool.max_pages_per_slot
                payload = (config.n_layers * width * self.page_size
                           * config.kv_heads * config.d_head)
                scales = config.n_layers * width * config.kv_heads
                self._staging = tuple(
                    torch.empty(size, dtype=dtype, pin_memory=True)
                    for size, dtype in ((payload, torch.int8),
                                        (scales, torch.float32),
                                        (payload, torch.int8),
                                        (scales, torch.float32)))
        #: (content_key, physical_page) demotions queued under the lock,
        #: gathered outside it on the pump thread
        self._pending_demotes: List[Tuple[bytes, int]] = []
        #: copy-lane jobs bringing gathered pages to host RAM
        self._demote_jobs: List[LaneJob] = []
        self.host_kv_hits = 0
        self.host_kv_misses = 0
        self.host_kv_demotions = 0
        self.host_kv_promotions = 0
        #: promotions whose copy failed and were recomputed instead
        self.host_kv_fallbacks = 0
        # the host tier on a serving mesh: rank 0's store is the index and
        # holds rank 0's shard of each page; every rank keeps its own shard
        # by the entry id rank 0 assigned
        #: (controller) the next entry id, and ids whose shards the other
        #: ranks must drop (sent as DROP)
        self._next_entry_id = 1
        self._host_drops: List[int] = []
        #: (worker) this rank's shards by entry id, its demotion copies in
        #: flight (job, ids), and ids dropped while their copy was in flight
        self._host_shards: Dict[int, HostPageEntry] = {}
        self._shard_jobs: List[Tuple[LaneJob, List[int]]] = []
        self._shards_dropped: set = set()
        if self._host_store is not None and mesh is not None \
                and mesh.is_controller:
            self._host_store.on_remove = self._host_entry_removed

        # the speculative lane: with it on, every tick is one draft propose
        # and one batched verify; the plain step is never dispatched
        self._spec: Optional[SpeculativeLane] = None
        if self.speculative == "on":
            # a self-draft takes the first blocks of THIS rank's shard
            self._spec = SpeculativeLane(self, *build_draft(
                self.params, config, draft_preset=draft_preset,
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
        #: the decode step as a CUDA graph (``step_graph.py``), captured at
        #: the first step (warmup's) and replayed by every later one
        self._step_graph: Optional[StepGraph] = None
        if graphs_the_step(self.device, mesh, self._spec is not None):
            operands = [(torch.int32, (self.capacity,)),
                        (torch.int32, (self.capacity,)),
                        (torch.bool, (self.capacity,)),
                        (torch.float32, (self.capacity,))]
            if self.paged:
                operands.append((torch.int32, self._pool.page_table.shape))
            self._step_graph = StepGraph(operands, self._generator,
                                         self.device)

        _QUEUE_CAPACITY.set(self.queue_depth)
        _SLOTS_TOTAL.set(self.capacity)
        _QUEUE_DEPTH.set(0)
        _SLOTS_BUSY.set(0)
        _MESH_DEVICES.set(self.num_devices)
        if self.paged:
            _KV_PAGES_TOTAL.set(self._pool.num_pages)
            _KV_PAGES_FREE.set(self._pool.free_pages)
            _KV_BYTES_CAPACITY.set(self._pool.num_pages * self._page_bytes)
            _KV_BYTES_USED.set(self._pool.used_pages * self._page_bytes)
            for index in range(self.capacity):
                _SLOT_PAGES.labels(slot=str(index)).set(0)
        if self._prefix is not None:
            _PREFIX_CACHED_PAGES.set(0)
        if self._host_store is not None:
            _HOST_KV_BYTES_CAPACITY.set(self.host_kv_bytes)
            _HOST_KV_BYTES_USED.set(0)
        if mesh is not None:
            mesh.builds += 1
            self._mesh_build = mesh.builds
            if mesh.is_controller:
                # the workers build their shard engines now (a
                # supervisor's rebuild reaches them the same way)
                self._mesh_command(OP_BUILD)

    @property
    def num_devices(self) -> int:
        """Ranks the engine spans: dp x tp (1 = a single device)."""
        return self.mesh_dp * self.mesh_tp

    @property
    def mesh_shape(self) -> str:
        """The mesh layout for stats: ``"dp x tp"``."""
        return f"{self.mesh_dp}x{self.mesh_tp}"

    @property
    def kv_cache_bytes(self) -> int:
        """Device bytes of this rank's KV cache (payload + scales)."""
        return sum(t.numel() * t.element_size() for t in self._cache)

    @property
    def param_bytes(self) -> int:
        """Device bytes of this rank's weights (its shard under a mesh)."""
        def leaves(node):
            if isinstance(node, dict):
                for value in node.values():
                    yield from leaves(value)
            elif isinstance(node, (list, tuple)):
                for value in node:
                    yield from leaves(value)
            else:
                yield node
        return sum(t.numel() * t.element_size()
                   for t in leaves(self.params))

    def _operand(self, value: np.ndarray) -> torch.Tensor:
        """Ship one per-slot host array to the engine's device."""
        return torch.from_numpy(value).to(self.device)

    # -- the serving mesh ---------------------------------------------------
    @property
    def is_mesh_worker(self) -> bool:
        """A worker rank's shard engine: driven by the controller's
        commands (``mesh_worker.serve_worker``), never by itself."""
        return self.mesh is not None and not self.mesh.is_controller

    def _check_driven(self) -> None:
        if self.is_mesh_worker:
            raise RuntimeError(
                "a serving-mesh worker's engine runs the controller's "
                "dispatches (serve_worker); submit to and step the engine "
                "on rank 0")

    def _mesh_command(self, op: int, args: Sequence[int] = (),
                      payload: Sequence[np.ndarray] = (),
                      body: Optional[Callable[[], object]] = None):
        """(controller) Send one command to the workers, run ``body`` (the
        device work the command mirrors) and sum every rank's flags. A
        worker that failed raises :class:`MeshWorkerError` here; the ranks
        that lacked a host shard the command named are left in
        ``_mesh_missing``. A failure part way through a tensor-parallel
        body leaves the tp collectives out of step between ranks: the mesh
        is marked broken and refuses every later command."""
        mesh = self.mesh
        if mesh.broken:
            raise MeshWorkerError(
                f"the serving mesh is broken ({mesh.broken}); restart its "
                "ranks")
        if self._mesh_build != mesh.builds:
            raise MeshWorkerError(
                "a newer engine was built on this serving mesh; this one "
                "no longer dispatches")
        self._mesh_last_command = time.monotonic()
        try:
            send_command(mesh, op, args, payload)
        except Exception as exc:
            mesh.broken = f"{type(exc).__name__}: {exc}"
            raise MeshWorkerError(
                f"serving-mesh command {op} could not reach the workers: "
                f"{exc}") from exc
        try:
            result = body() if body is not None else None
        except Exception as exc:
            if mesh.tp > 1 and op in TP_BODIES:
                mesh.broken = (f"command {op} failed part way on rank 0: "
                               f"{type(exc).__name__}: {exc}")
                raise MeshWorkerError(
                    f"serving-mesh command {op} failed part way (a worker "
                    f"gone, or rank 0's own body): {exc}") from exc
            result, failure = None, exc
        else:
            failure = None
        try:
            failed, self._mesh_missing = finish_command(mesh,
                                                        failure is not None)
        except Exception as exc:
            mesh.broken = f"{type(exc).__name__}: {exc}"
            raise MeshWorkerError(
                f"serving-mesh command {op}: a worker rank is gone ({exc})"
            ) from exc
        if failure is not None:
            raise failure
        if failed:
            raise MeshWorkerError(
                f"{failed} serving-mesh worker rank(s) failed command {op}")
        return result

    def _mesh_heartbeat(self) -> None:
        """(controller, idle) A ``PING`` once ``heartbeat_s`` passed with
        no command, so the workers' wait never reaches the process group's
        timeout — and a dead worker surfaces while idle too."""
        if (time.monotonic() - self._mesh_last_command
                >= self.mesh.heartbeat_s):
            self._mesh_command(OP_PING)

    def stop_workers(self) -> None:
        """(controller) End the workers' ``serve_worker`` loops
        (``mesh_worker.stop_workers``); a no-op without a mesh."""
        if self.mesh is not None:
            stop_workers(self.mesh)

    def _serve_dispatch(self, op: int, args: Sequence[int],
                        payload: np.ndarray) -> bool:
        """(worker) Run one of the controller's dispatches on this rank's
        shards, with its operands: the body the controller runs, after this
        engine's own fault point and counters. Returns True when an
        ``INJECT`` named a host shard this rank lacks. Finished demotion
        copies are adopted first, whatever the command."""
        self._adopt_shard_jobs()
        slots = self.capacity

        def page_table(flat: np.ndarray) -> Optional[np.ndarray]:
            return flat.reshape(slots, -1) if self.paged else None

        if op == OP_STEP:
            tokens, positions = payload[:slots], payload[slots:2 * slots]
            self._fault_point("step")
            self.step_dispatches += 1
            self._step_device(tokens, positions, None, None,
                              page_table(payload[2 * slots:]))
            return False
        if op == OP_PREFILL:
            slot, real_len, width = args[:3]
            row = payload[width:] if self.paged else None
            self._fault_point("prefill")
            self.prefills += 1
            self._prefill_device(payload[:width].reshape(1, width), slot,
                                 real_len, row)
            return False
        if op == OP_CHUNK:
            start, real_len, width = args[:3]
            self._fault_point("prefill")
            self.prefill_chunks += 1
            self._chunk_prefill_device(payload[:width].reshape(1, width),
                                       start, real_len, payload[width:])
            return False
        if op == OP_PROPOSE:
            width = self.spec_tokens + 1
            window = payload[:slots * width].reshape(slots, width)
            lens, positions, limits = payload[
                slots * width:slots * (width + 3)].reshape(3, slots)
            self._fault_point("step")
            self._spec.propose(window, lens, positions, limits,
                               page_table(payload[slots * (width + 3):]))
            return False
        if op == OP_VERIFY:
            width = self.spec_tokens + 1
            window = payload[:slots * width].reshape(slots, width)
            positions, limits = payload[
                slots * width:slots * (width + 2)].reshape(2, slots)
            self._fault_point("verify")
            self.step_dispatches += 1
            self._verify_device(window, positions, None, None, limits,
                                page_table(payload[slots * (width + 2):]))
            return False
        # the host tier's commands: args[0] page ids, then the entry ids
        # (DROP: no pages)
        count = args[0]
        pages = payload[:count]
        ids = [int(i) for i in words_to_ids(payload[count:])]
        if op == OP_EXTRACT:
            self._fault_point("extract")
            self._extract_shard(pages, ids)
            return False
        if op == OP_INJECT:
            self._fault_point("inject")
            return self._inject_shard(pages, ids)
        if op == OP_DROP:
            self._drop_shards(ids)
            return False
        raise ValueError(f"not a dispatch: command {op}")

    # -- admission --------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               temperature: float = 0.0,
               user_key: Optional[str] = None,
               deadline_s: Optional[float] = None) -> GenerationHandle:
        """Queue one request; raises ``ValueError`` on malformed input (and
        on a request the page pool can never hold), ``RateLimitError``/
        ``QueueFullError`` on admission failure, ``EngineDrainingError``
        while the engine drains — each carrying a Retry-After estimate.

        ``deadline_s`` overrides the engine's ``default_deadline_s``
        (capped by ``max_deadline_s``); the deadline binds in the queue,
        mid-prefill and mid-decode, where the request ends with the
        outcome ``timeout``."""
        self._check_driven()
        if self._draining:
            raise EngineDrainingError(
                "engine is draining: in-flight requests are finishing, no "
                "new admissions; retry after the drain completes",
                retry_after_s=self.drain_retry_after())
        if deadline_s is not None:
            deadline_s = float(deadline_s)
            if not 0.0 < deadline_s <= self.max_deadline_s:
                raise ValueError(
                    f"deadline_s must be in (0, {self.max_deadline_s:g}], "
                    f"got {deadline_s:g}")
        elif self.default_deadline_s > 0:
            deadline_s = self.default_deadline_s
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
        ledger = get_request_ledger()
        submitted_ts = self.clock()
        request = _Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                           temperature=float(temperature),
                           user_key=str(user_key) if user_key else None,
                           submitted_ts=submitted_ts,
                           request_id=ledger.new_request_id(),
                           submitted_wall=time.time(),
                           deadline_ts=(submitted_ts + deadline_s
                                        if deadline_s else None))
        request.record = ledger.begin(
            request.request_id, prompt_tokens=len(prompt),
            max_new_tokens=request.max_new_tokens,
            temperature=request.temperature, user_key=request.user_key,
            submitted_ts=request.submitted_wall)
        handle = GenerationHandle(self, request)
        request.handle = handle
        with self._lock:
            if (self.max_concurrent_per_user > 0 and request.user_key
                    and self._user_active.get(request.user_key, 0)
                    >= self.max_concurrent_per_user):
                _REQUESTS.labels(outcome="rejected_ratelimit").inc()
                self._record_rejection_locked(request, "rejected_ratelimit")
                raise RateLimitError(
                    f"user has {self.max_concurrent_per_user} generation "
                    "requests in flight; retry when one completes",
                    retry_after_s=self._retry_after_locked(),
                    request_id=request.request_id)
            if len(self._pending) >= self.queue_depth:
                _REQUESTS.labels(outcome="rejected_queue").inc()
                self._record_rejection_locked(request, "rejected_queue")
                raise QueueFullError(
                    f"admission queue is full ({self.queue_depth} waiting); "
                    "retry shortly",
                    retry_after_s=self._retry_after_locked(
                        needed_pages=(self._pool.pages_for(
                            len(prompt) + max_new_tokens)
                            if self.paged else None),
                        prompt=prompt),
                    request_id=request.request_id)
            if request.user_key:
                self._user_active[request.user_key] = (
                    self._user_active.get(request.user_key, 0) + 1)
            self._pending.append(request)
            _QUEUE_DEPTH.set(len(self._pending))
        return handle

    def _retry_after_locked(self, needed_pages: Optional[int] = None,
                            prompt: Optional[Sequence[int]] = None) -> float:
        """Retry-After estimate (floor 1 s), as JAX computes it.
        Contiguous: the time for the running sequence with the fewest
        tokens left to free its slot at the observed inter-token p50. Paged
        with ``needed_pages``: walk the running sequences in completion
        order, counting a page available when its LAST slot holder
        completes (shared pages must not count twice), on top of the free
        and cache-only (evictable) pages, and answer the completion time at
        which ``needed_pages`` fit. With ``prompt``, the prefix cache's
        matched pages (granted shared) and, with the tier on, the
        host-resident continuation pages (filled by copy, not recompute)
        come off the bill."""
        per_token = self._intertoken_hist.quantile(0.5) or 0.05
        running = [
            (slot.request.max_new_tokens - len(slot.request.generated), index)
            for index, slot in enumerate(self._slots) if slot is not None]
        if not running:
            return 1.0
        if self.paged and needed_pages is not None:
            if prompt is not None and self._prefix is not None:
                _, shared = self._prefix.match(prompt)
                discount = len(shared)
                if self._host_store is not None:
                    limit = (self._prefix.cacheable_tokens(len(prompt))
                             // self.page_size)
                    index = len(shared)
                    while index < limit and page_content_key(
                            prompt, index, self.page_size) in self._host_store:
                        discount += 1
                        index += 1
                needed_pages = max(1, needed_pages - discount)
            available = self._pool.free_pages
            if self._prefix is not None:
                available += self._pool.cached_only_pages()
            if available < needed_pages:
                slot_refs = self._pool.slot_ref_counts()
                eta_tokens = 0
                for remaining, index in sorted(running):
                    for page in self._pool.owned_pages(index):
                        slot_refs[page] -= 1
                        if slot_refs[page] == 0:
                            available += 1      # net-releasable now
                    eta_tokens = remaining
                    if available >= needed_pages:
                        break
                return max(1.0, round(eta_tokens * per_token, 1))
        return max(1.0, round(min(r for r, _ in running) * per_token, 1))

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

    def drain_retry_after(self) -> float:
        """Retry-After while draining: the estimated time for every
        in-flight request to finish at the observed inter-token p50 — the
        slowest running slot plus the queued work spread over the slot
        pool (floor 1 s)."""
        with self._lock:
            per_token = self._intertoken_hist.quantile(0.5) or 0.05
            running = [slot.request.max_new_tokens
                       - len(slot.request.generated)
                       for slot in self._slots if slot is not None]
            queued = sum(request.max_new_tokens
                         for request in self._pending)
            tokens_left = (max(running) if running else 0) + (
                queued / max(1, self.capacity))
            return max(1.0, round(tokens_left * per_token, 1))

    def _record_rejection_locked(self, request: _Request,
                                 outcome: str) -> None:
        """Ledger a shed request: a row with its outcome, though no phase
        past the submit ran."""
        record = request.record
        if record is not None:
            get_request_ledger().finish(
                record, outcome, finished_ts=request.wall(self.clock()))

    # -- scheduler --------------------------------------------------------
    def has_work(self) -> bool:
        with self._lock:
            # the tier's backlog counts: queued demotions still need their
            # gather, copies in flight need adopting into the store, and
            # (on a mesh) entries the store let go need dropping everywhere
            return (bool(self._pending)
                    or any(slot is not None for slot in self._slots)
                    or bool(self._pending_demotes)
                    or bool(self._demote_jobs)
                    or bool(self._host_drops))

    def _meter_tick(self) -> None:
        """Integrate one tick's resource-time products into the tenant
        meter: every busy slot is charged from ONE dt sample, and
        ``busy_slot_seconds`` accumulates from the same samples, so the
        conservation ``sum(tenant device-seconds) == busy_slot_seconds x
        num_devices`` is exact. The meter's lock is a leaf, taken after the
        engine lock is released."""
        meter = self.tenant_meter
        now = self.clock()
        last = self._last_meter_ts
        self._last_meter_ts = now
        if last is None:
            return
        dt = now - last
        if dt <= 0:
            return
        devices = self.num_devices
        charges: Dict[str, List[float]] = {}
        with self._lock:
            for index, slot in enumerate(self._slots):
                if slot is None:
                    continue
                request = slot.request
                tenant = request.user_key or ANONYMOUS_TENANT
                self.busy_slot_seconds += dt
                entry = charges.get(tenant)
                if entry is None:
                    entry = charges[tenant] = [0.0, 0.0, 0.0]
                device_s = dt * devices
                if self.paged:
                    kv_byte_s = (self._pool.owned_count(index)
                                 * self._page_bytes * dt)
                else:
                    kv_byte_s = self._slot_kv_bytes * dt
                entry[0] += device_s
                entry[1] += kv_byte_s
                request.device_seconds += device_s
                request.kv_byte_seconds += kv_byte_s
                if slot.promote_entries:
                    # host-tier residency: pages this request's promotion
                    # still holds in the host store
                    entry[2] += sum(e.nbytes
                                    for e in slot.promote_entries) * dt
        if charges:
            meter.charge_tick({tenant: (entry[0], entry[1], entry[2])
                               for tenant, entry in charges.items()})

    def step(self) -> int:
        """One scheduler iteration: tick the host tier's copies (adopt what
        landed, gather queued demotions ahead of anything that could
        overwrite their pages), admit joins, advance every prefill in
        progress by ONE chunk (``prefill_chunk_tokens`` bounds the prefill
        work a tick inserts between two decode steps), then advance the
        running batch one token. Returns the number of active slots
        stepped.

        With a tenant meter the tick is charged first; with a flight
        recorder it is stamped into the ring in a ``finally``, so the tick
        that raises is recorded too, with the tick's start on the wall
        clock and its phases (``flight_recorder.TickMarks``: one clock
        sample per boundary). Both are host bookkeeping only: without a
        recorder no boundary is sampled."""
        self._check_driven()
        if self.tenant_meter is not None:
            self._meter_tick()
        recorder = self.flight_recorder
        if recorder is None:
            if self._host_store is not None:
                self._pump_host_lane()
            self._admit()
            self._advance_prefills()
            return self._decode_step()
        started = self.clock()
        if self._wall_anchor is None:
            self._wall_anchor = (started, time.time())
        faults_before = self._faults_injected()
        loads_before = cuda_build.load_count()
        demotions_before = self.host_kv_demotions
        promotions_before = self.host_kv_promotions
        admitted = chunks = stepped = 0
        marks = TickMarks(started)
        try:
            if self._host_store is not None:
                self._pump_host_lane()
                marks.admit = self.clock()
            admitted = self._admit()
            marks.prefill = self.clock()
            chunks = self._advance_prefills()
            stepped = self._decode_step(marks)
            if marks.dispatch is None:
                marks.dispatch = self.clock()   # no step: the prefills end
            return stepped
        finally:
            with self._lock:
                busy = self._busy_locked()
                depth = len(self._pending)
            anchor_clock, anchor_wall = self._wall_anchor
            recorder.record(
                duration_s=self.clock() - started,
                admitted=admitted,
                prefill_chunks=chunks,
                decode_slots=stepped,
                slots_busy=busy,
                queue_depth=depth,
                pages_free=self._pool.free_pages if self.paged else 0,
                compiles=cuda_build.load_count() - loads_before,
                faults=self._faults_injected() - faults_before,
                host_demotions=self.host_kv_demotions - demotions_before,
                host_promotions=self.host_kv_promotions - promotions_before,
                start_ts=anchor_wall + (started - anchor_clock),
                **marks.phases(),
            )

    def _faults_injected(self) -> int:
        """Injections the fault plan has made (0 without a plan): the
        recorder diffs this per tick."""
        plan = self.fault_plan
        if plan is None:
            return 0
        return sum(plan.faults_injected.values())

    def pump(self, budget_s: Optional[float] = None,
             should_stop: Optional[Callable[[], bool]] = None) -> int:
        """Run scheduler iterations until idle, the wall budget is spent,
        or ``should_stop()``. An idle controller of a serving mesh sends
        its workers a heartbeat."""
        deadline = None if budget_s is None else self.clock() + budget_s
        steps = 0
        if self.mesh is not None and not self.has_work():
            self._mesh_heartbeat()
        while self.has_work():
            if should_stop is not None and should_stop():
                break
            if deadline is not None and self.clock() >= deadline:
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
        one propose and one verify instead of the step. A tiered engine
        also takes the trash page through the tier's whole path: gather,
        copy out, copy back, inject (its own bytes, to the write sink).
        On a serving mesh the controller's warmup warms every rank: the
        lane's bodies and, with the tier, every rank's extract, copies and
        inject (the warm entry dropped after)."""
        self._check_driven()
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
            if self._host_store is not None:
                ids = self._new_entry_ids(1)
                _, [page] = self._materialize_demotion(
                    [b""], *self._dispatch_page_extract([TRASH_PAGE], ids))
                self._dispatch_page_inject(
                    [TRASH_PAGE], self._stage_promotion(
                        [HostPageEntry(*page, last_used=0)]), ids)
                if ids is not None:
                    self._host_drops.extend(ids)
                    self._flush_host_drops()
        else:
            buckets = {_prefill_bucket(max(1, length - 1), self.max_len - 1)
                       for length in prompt_lens} or {
                           _prefill_bucket(1, self.max_len - 1)}
            for width in sorted(buckets):
                self._dispatch_prefill(np.zeros((1, width), np.int32),
                                       slot=0, real_len=0)
        if self._spec is None:
            self._run_step().cpu()
            return
        # a fresh engine's operands: empty windows, limits -1, every row
        # at the trash page, so no speculative write lands on a real page
        with self._lock:
            window, lens, limits, page_table = self._spec_operands_locked()
        proposals = self._run_spec_propose(window, lens, limits,
                                           page_table).cpu().numpy()
        verify_window = np.concatenate([self._tokens[:, None], proposals],
                                       axis=1)
        self._run_spec_verify(verify_window, limits, page_table)[0].cpu()

    # -- internals --------------------------------------------------------
    def _fault_point(self, kind: str) -> None:
        """Fault-injection seam, consulted at the top of every dispatch,
        before its first in-place write to the cache: an injected fault
        leaves the cache as it was. A no-op without a plan."""
        if self.fault_plan is not None:
            self.fault_plan.before_dispatch(kind)

    def _dispatch_prefill(self, head: np.ndarray, slot: int,
                          real_len: int) -> None:
        """The whole-prompt prefill through whichever layout this engine
        uses: the slot's page-table row (paged) or its cache row."""
        self._fault_point("prefill")
        self.prefills += 1
        row = self._pool.page_table[slot].copy() if self.paged else None

        def body():
            self._prefill_device(head, slot, real_len, row)

        if self.mesh is None:
            return body()
        self._mesh_command(
            OP_PREFILL, (slot, real_len, head.shape[1]),
            [head] + ([row] if self.paged else []), body)

    def _prefill_device(self, head: np.ndarray, slot: int, real_len: int,
                        row: Optional[np.ndarray]) -> None:
        """The whole-prompt prefill's device body, and the speculative
        lane's mirror of it right after (the same head and row)."""
        if self.paged:
            _paged_prefill_body(self.params, self._operand(head),
                                self._cache, self._operand(row),
                                int(real_len), self.config, self._tp)
        else:
            _prefill_body(self.params, self._operand(head), self._cache,
                          int(slot), int(real_len), self.config, self._tp)
        if self._spec is not None:
            self._spec.prefill(head, slot, real_len, row)

    def _dispatch_chunk_prefill(self, head: np.ndarray, slot: int,
                                start: int, real_len: int) -> None:
        """One prefill chunk (positions ``start .. start + real_len - 1``)
        through the slot's page-table row."""
        self._fault_point("prefill")
        self.prefill_chunks += 1
        row = self._pool.page_table[slot].copy()

        def body():
            self._chunk_prefill_device(head, start, real_len, row)

        if self.mesh is None:
            return body()
        self._mesh_command(OP_CHUNK, (start, real_len, head.shape[1]),
                           [head, row], body)

    def _chunk_prefill_device(self, head: np.ndarray, start: int,
                              real_len: int, row: np.ndarray) -> None:
        """One chunk's device body, and the speculative lane's mirror of it
        right after — before the radix tree adopts the chunk's pages, so a
        cached page carries both lanes' K/V."""
        _paged_chunk_prefill_body(
            self.params, self._operand(head), self._cache,
            self._operand(row), int(start), int(real_len), self.config,
            self._tp)
        if self._spec is not None:
            self._spec.chunk_prefill(head, start, real_len, row)

    def _run_step(self) -> torch.Tensor:
        self._fault_point("step")
        self.step_dispatches += 1
        page_table = None
        if self.paged:
            page_table = self._pool.page_table
            if self._use_chunk_prefill:
                # a mid-prefill slot's row already points at REAL pages
                # (shared prefix pages above all), but the step writes K/V
                # for every slot at its frozen position: route inactive
                # rows to the trash page in the operand, so that write
                # never lands on a page another sequence reads
                page_table = page_table.copy()
                page_table[~self._active] = TRASH_PAGE

        def body():
            return self._step_device(self._tokens, self._positions,
                                     self._active, self._temps, page_table)

        if self.mesh is None:
            return body()
        return self._mesh_command(
            OP_STEP, (), [self._tokens, self._positions]
            + ([page_table] if self.paged else []), body)

    def _step_device(self, tokens: np.ndarray, positions: np.ndarray,
                     active: Optional[np.ndarray],
                     temps: Optional[np.ndarray],
                     page_table: Optional[np.ndarray]
                     ) -> Optional[torch.Tensor]:
        """The decode step's device body; a worker passes no ``active``/
        ``temps`` (it does not sample) and gets None back. An engine with a
        step graph stages the arrays and replays it, except while a device
        profile is captured (``step_graph.py``)."""
        if active is None:
            active = np.zeros(self.capacity, bool)
            temps = np.zeros(self.capacity, np.float32)
        arrays = [tokens, positions, active, temps]
        if self.paged:
            arrays.append(page_table)
        if self._step_graph is not None and not capture_in_flight():
            return self._step_graph.run(self._step_on, arrays)
        return self._step_on(*(self._operand(array) for array in arrays))

    def _step_on(self, tokens: torch.Tensor, positions: torch.Tensor,
                 active: torch.Tensor, temps: torch.Tensor,
                 page_table: Optional[torch.Tensor] = None
                 ) -> Optional[torch.Tensor]:
        """The decode step's body on device operands."""
        if not self.paged:
            return _step_body(self.params, tokens, positions, active, temps,
                              self._cache, self._generator, self.config,
                              self.top_k, self._tp)
        return _paged_step_body(
            self.params, tokens, positions, active, temps, page_table,
            self._cache, self._generator, self.config, self.top_k, self._tp)

    # -- KV-page tiering internals ------------------------------------------
    #
    # Threads: the HostPageStore is read and written ONLY on the pump
    # thread; the copy lane's thread does the copies' host side (pinned
    # staging, enqueueing on the copy stream, waiting for it) and publishes
    # through LaneJob.done. The gather and the inject are dispatched on the
    # pump thread outside the engine lock, on the compute stream, like
    # every other dispatch. On the card, the copy stream orders itself
    # after the gather by an event, the inject's stream waits on the copy's
    # event, and the tensors that cross streams stay alive (held in the job)
    # or are marked with record_stream.
    #
    # On a serving mesh every rank runs the same on its own cache shard and
    # its own copy lane; no collective ever runs on a lane thread (gloo's
    # collectives must come in one order on every rank). Rank 0's store is
    # the tier's one index; a worker keeps its shards in _host_shards by
    # entry id, adopts its finished copies when it reads a command, and
    # waits for its own copy at INJECT.

    def _new_entry_ids(self, count: int) -> Optional[List[int]]:
        """(controller) ``count`` fresh entry ids on a serving mesh (None
        without one): the names every rank files its shards under."""
        if self.mesh is None:
            return None
        first = self._next_entry_id
        self._next_entry_id += count
        return list(range(first, first + count))

    def _host_entry_removed(self, entry: HostPageEntry) -> None:
        """(controller) The store let ``entry`` go (evicted, replaced or
        discarded): the other ranks drop their shards of it."""
        self._host_drops.append(entry.entry_id)

    def _flush_host_drops(self) -> None:
        """(controller) Send the entry ids the store let go (``DROP``), so
        no rank's host bytes outgrow the store's accounting — all but those
        a parked promotion still holds: as in JAX, an entry the store
        evicts after a hit took it is still promoted from, and its drop
        waits for the inject (or the fallback)."""
        if self.mesh is None or not self._host_drops:
            return
        with self._lock:
            held = {entry.entry_id for state in self._slots
                    if state is not None for entry in state.promote_entries}
        drops = [entry_id for entry_id in self._host_drops
                 if entry_id not in held]
        self._host_drops = [entry_id for entry_id in self._host_drops
                            if entry_id in held]
        if drops:
            self._mesh_command(OP_DROP, (0,), [ids_to_words(drops)])

    def _dispatch_page_extract(self, pages: Sequence[int],
                               ids: Optional[List[int]] = None):
        """Gather ``pages`` for demotion: ``(extracted, ready)`` with
        ``ready`` an event recorded on the compute stream after the gather
        (None on the CPU). Dispatched before anything that could overwrite
        the pages, so it reads them as they were. On a serving mesh every
        rank gathers its shard (``EXTRACT``) and copies it down on its own
        lane under ``ids``."""
        self._fault_point("extract")
        pages = np.asarray(pages, np.int32)
        if self.mesh is None:
            return self._extract_device(pages)
        return self._mesh_command(
            OP_EXTRACT, (len(pages),), [pages, ids_to_words(ids)],
            lambda: self._extract_device(pages))

    def _extract_device(self, pages: np.ndarray):
        extracted = _page_extract_body(self._cache, self._operand(pages))
        if self._copy_stream is None:
            return extracted, None
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return extracted, ready

    def _staged_run(self, count: int) -> Tuple[torch.Tensor, ...]:
        """``(k, k_scale, v, v_scale)`` ``[L, count, ...]`` host tensors for
        one lane job: contiguous views of the pinned staging on the card
        (the caller holds ``_staging_lock``), fresh tensors on the CPU. On a
        serving mesh a page is this rank's shard: its KV heads."""
        config = self.config
        heads = self._cache.k.shape[3]
        payload = (config.n_layers, count, self.page_size, heads,
                   config.d_head)
        scales = (config.n_layers, count, heads)
        shapes = (payload, scales, payload, scales)
        dtypes = (torch.int8, torch.float32) * 2
        if not self._staging:
            return tuple(torch.empty(shape, dtype=dtype)
                         for shape, dtype in zip(shapes, dtypes))
        return tuple(flat[:int(np.prod(shape))].view(shape)
                     for flat, shape in zip(self._staging, shapes))

    def _materialize_demotion(self, keys: List[bytes], extracted,
                              ready: Optional[torch.cuda.Event]):
        """(copy lane) Bring gathered pages to host RAM and split them:
        returns ``(keys, pages)``, one ``(k, v, k_scale, v_scale)`` of
        numpy copies per key — per-page copies, since a view into the
        batch would pin the whole transfer buffer and lie to byte
        accounting. On the card the copy runs on the copy stream, after
        the gather's event, into the pinned staging, and is waited for
        here, never on the pump. The job's closure holds ``extracted``
        until the pump drops the finished job, so the gathered tensors
        outlive the copy that reads them."""
        if ready is None:
            return keys, self._split_pages(extracted, len(keys))
        with self._staging_lock:
            host = self._staged_run(len(keys))
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._copy_stream):
                self._copy_stream.wait_event(ready)
                for pinned, tensor in zip(host, extracted):
                    pinned.copy_(tensor, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._copy_stream)
            done.synchronize()
            return keys, self._split_pages(host, len(keys))

    @staticmethod
    def _split_pages(host, count: int) -> List[Tuple[np.ndarray, ...]]:
        """One ``(k, v, k_scale, v_scale)`` per page, each a numpy array of
        its own memory, filled by ONE torch copy per array
        (``_foreach_copy_``, which runs without the interpreter lock): the
        pump's decode step is thousands of small calls that each take the
        lock back, and a lane thread taking it once a page slows every one
        of them."""
        columns = []
        for tensor in (host[0], host[2], host[1], host[3]):   # k, v, scales
            shape = tensor.shape[:1] + tensor.shape[2:]
            dtype = np.int8 if tensor.dtype == torch.int8 else np.float32
            pages = [np.empty(shape, dtype) for _ in range(count)]
            torch._foreach_copy_([torch.from_numpy(page) for page in pages],
                                 list(tensor.unbind(1)))
            columns.append(pages)
        return list(zip(*columns))

    def _stage_promotion(self, entries: List[HostPageEntry]):
        """(copy lane) Assemble the promotion run — only its real pages —
        into ``(k, k_scale, v, v_scale)`` ``[L, n, ...]``, and on the card
        copy it up: assembled in the pinned staging, copied on the copy
        stream, waited for here. Returns ``(tensors, done)`` with ``done``
        the copy's event (None on the CPU)."""
        def assemble(staged):
            # one torch op per array, for the reason _split_pages gives
            for target, name in zip(staged, ("k", "k_scale", "v",
                                             "v_scale")):
                torch.stack([torch.from_numpy(getattr(entry, name))
                             for entry in entries], dim=1, out=target)
            return staged

        if self._copy_stream is None:
            return assemble(self._staged_run(len(entries))), None
        with self._staging_lock:
            staged = assemble(self._staged_run(len(entries)))
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._copy_stream):
                on_device = tuple(t.to(self.device, non_blocking=True)
                                  for t in staged)
                done = torch.cuda.Event()
                done.record(self._copy_stream)
            done.synchronize()
        return on_device, done

    def _dispatch_page_inject(self, pages: Sequence[int], staged,
                              ids: Optional[List[int]] = None) -> int:
        """Scatter a staged run into the slot's fresh pages, in place. On
        a serving mesh every rank stages and scatters its shard of the
        entries ``ids`` (``INJECT``); returns the number of ranks that
        lacked one (0 without a mesh), whose pages must be recomputed."""
        self._fault_point("inject")
        pages = np.asarray(pages, np.int32)
        if self.mesh is None:
            self._inject_device(pages, staged)
            return 0
        self._mesh_command(OP_INJECT, (len(pages),),
                           [pages, ids_to_words(ids)],
                           lambda: self._inject_device(pages, staged))
        return self._mesh_missing

    def _inject_device(self, pages: np.ndarray, staged) -> None:
        """On the card the compute stream first waits on the copy's event,
        and the copied tensors, allocated on the copy stream, are marked as
        used by the compute stream, so the allocator cannot hand their
        memory out again while the inject still reads it."""
        tensors, done = staged
        if done is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            for tensor in tensors:
                tensor.record_stream(compute)
        _page_inject_body(self._cache, self._operand(pages), *tensors)

    # -- the host tier on a serving-mesh worker --------------------------------
    def _extract_shard(self, pages: np.ndarray, ids: List[int]) -> None:
        """(worker) ``EXTRACT``: gather this rank's shard of ``pages`` and
        hand the copy down to this rank's lane, filed under ``ids``."""
        extracted, ready = self._extract_device(pages)
        job = self._host_lane.submit(functools.partial(
            self._materialize_demotion, list(ids), extracted, ready))
        self._shard_jobs.append((job, list(ids)))

    def _adopt_shard_jobs(self) -> None:
        """(worker) File this rank's finished demotion copies by entry id
        (a failed copy files nothing: its ids stay missing)."""
        still_running = []
        for job, ids in self._shard_jobs:
            if not job.done:
                still_running.append((job, ids))
                continue
            if job.error is not None:
                log.warning("host-kv demotion of entries %s dropped on rank "
                            "%d: %s", ids, self.mesh.rank, job.error)
                self._shards_dropped.difference_update(ids)
                continue
            for entry_id, page in zip(*job.result):
                if entry_id in self._shards_dropped:
                    self._shards_dropped.discard(entry_id)
                else:
                    self._host_shards[entry_id] = HostPageEntry(
                        *page, last_used=0, entry_id=entry_id)
        self._shard_jobs = still_running

    def _inject_shard(self, pages: np.ndarray, ids: List[int]) -> bool:
        """(worker) ``INJECT``: wait for this rank's own copy of the
        entries if it is still in flight (at most the mesh's heartbeat
        period), then stage and scatter the shards. Returns True, injecting
        nothing, when a shard is missing: the controller recomputes the
        pages. The controller waits in the command's closing collective
        meanwhile, and sends no heartbeat: both run on its pump thread."""
        pending = [job for job, job_ids in self._shard_jobs
                   if not job.done and set(job_ids) & set(ids)]
        for job in pending:
            job.wait(self.mesh.heartbeat_s)
        self._adopt_shard_jobs()
        entries = [self._host_shards.get(entry_id) for entry_id in ids]
        if any(entry is None for entry in entries):
            return True
        self._inject_device(pages, self._stage_promotion(entries))
        return False

    def _drop_shards(self, ids: List[int]) -> None:
        """(worker) ``DROP``: forget this rank's shards of ``ids``; a copy
        still in flight is forgotten when it lands."""
        in_flight = {entry_id for job, job_ids in self._shard_jobs
                     for entry_id in job_ids}
        for entry_id in ids:
            if self._host_shards.pop(entry_id, None) is None \
                    and entry_id in in_flight:
                self._shards_dropped.add(entry_id)

    @property
    def host_shard_bytes(self) -> int:
        """(worker) Host bytes of this rank's shards: its share of the
        pages rank 0's store lists."""
        return sum(entry.nbytes for entry in self._host_shards.values())

    def _spill_page_locked(self, key: bytes, page: int) -> None:
        """PrefixCache eviction hook (under the engine lock, BEFORE the
        victim's reference drops): queue a demotion. The pump gathers it
        right after the lock releases, before any prefill can be
        dispatched at the recycled page."""
        if key not in self._host_store:
            self._pending_demotes.append((key, page))

    def _queue_slot_demotions_locked(self, index: int, state: _Slot) -> None:
        """Queue demotions for a leaving slot's sole-held prefix pages:
        fully dispatched cacheable pages with refcount 1 (the tree never
        adopted them or already let go), which release() is about to
        net-free. Shared pages are the tree's to spill when it evicts
        them."""
        prompt = state.request.prompt
        covered = min(state.prefill_next,
                      self._prefix.cacheable_tokens(len(prompt)))
        row = self._pool.owned_pages(index)
        for page_index in range(covered // self.page_size):
            page = row[page_index]
            if self._pool.refcount(page) != 1:
                continue
            key = page_content_key(prompt, page_index, self.page_size)
            if key in self._host_store:
                continue
            self._pending_demotes.append((key, page))

    def _probe_host_locked(self, prompt: Sequence[int],
                           start_pages: int) -> List[HostPageEntry]:
        """Walk successive content keys past the device match; returns the
        resident continuation run (LRU-touched). The prefix_min_tokens gate
        of match() applies: a promotion covering less is not worth its
        copy."""
        limit = self._prefix.cacheable_tokens(len(prompt)) // self.page_size
        entries: List[HostPageEntry] = []
        index = start_pages
        while index < limit:
            entry = self._host_store.get(
                page_content_key(prompt, index, self.page_size))
            if entry is None:
                break
            entries.append(entry)
            index += 1
        if entries and index * self.page_size < self.prefix_min_tokens:
            entries = []
        if entries:
            self.host_kv_hits += 1
            _HOST_KV_HITS.inc()
        else:
            self.host_kv_misses += 1
            _HOST_KV_MISSES.inc()
        return entries

    def _pump_host_lane(self) -> None:
        """Tick the tier — first thing in step(), before admission: gather
        queued demotions ahead of anything that could overwrite their
        pages, adopt finished copies. Poll and dispatch only; a copy still
        in flight is picked up on a later tick. On a serving mesh the
        entries the store let go are dropped on every rank last."""
        self._dispatch_demotions()
        self._adopt_demotions()
        self._adopt_promotions()
        self._flush_host_drops()

    def _dispatch_demotions(self) -> None:
        """Drain queued demotions: gather their pages (pump thread, outside
        the lock) and hand them to the lane for the copy to host RAM."""
        with self._lock:
            pending, self._pending_demotes = self._pending_demotes, []
        width = self._pool.max_pages_per_slot
        for start in range(0, len(pending), width):
            group = pending[start:start + width]
            ids = self._new_entry_ids(len(group))
            try:
                extracted, ready = self._dispatch_page_extract(
                    [page for _, page in group], ids)
            except Exception:
                # nothing of this group was gathered: it and the rest go
                # back to the head of the queue, which the next tick
                # gathers before anything else
                with self._lock:
                    self._pending_demotes[:0] = pending[start:]
                raise
            self._demote_jobs.append((self._host_lane.submit(
                functools.partial(self._materialize_demotion,
                                  [key for key, _ in group], extracted,
                                  ready)), ids))

    def _adopt_demotions(self) -> None:
        """Adopt finished copies into the host store (pump thread: the
        store's single writer). On a serving mesh an entry is filed with
        its id and charged the whole page's bytes; the ids of entries that
        never entered the store (a failed copy, an entry past the budget)
        and of those it let go are queued for dropping on every rank."""
        still_running: List[Tuple[LaneJob, Optional[List[int]]]] = []
        for job, ids in self._demote_jobs:
            if not job.done:
                still_running.append((job, ids))
                continue
            if job.error is not None:
                log.warning("host-kv demotion dropped: %s", job.error)
                if ids is not None:
                    self._host_drops.extend(ids)
                continue
            keys, pages = job.result
            if ids is None:
                adopted = sum(self._host_store.put(key, *page)
                              for key, page in zip(keys, pages))
            else:
                adopted = 0
                for key, page, entry_id in zip(keys, pages, ids):
                    if self._host_store.put(key, *page,
                                            nbytes=self._page_bytes,
                                            entry_id=entry_id):
                        adopted += 1
                    else:
                        self._host_drops.append(entry_id)
            if adopted:
                with self._lock:
                    self.host_kv_demotions += adopted
                _HOST_KV_DEMOTIONS.inc(adopted)
            _HOST_KV_BYTES_USED.set(self._host_store.bytes_used)
        self._demote_jobs = still_running

    def _adopt_promotions(self) -> None:
        """Poll parked slots' staging jobs; for each finished one, inject
        the run and resume the slot's prefill past ``promote_boundary``. A
        failed copy falls back to recomputing the span, logged and counted
        in ``host_kv_fallbacks``. Slots are freed only on this pump thread,
        so the identity check under the lock holds through the inject."""
        with self._lock:
            parked = [(index, state)
                      for index, state in enumerate(self._slots)
                      if state is not None and state.promote_job is not None]
        for index, state in parked:
            job = state.promote_job
            if not job.done:
                continue
            if job.error is not None:
                log.warning("host-kv promotion failed (slot %d): %s — "
                            "falling back to recompute", index, job.error)
                with self._lock:
                    if self._slots[index] is state:
                        self.host_kv_fallbacks += 1
                        state.promote_job = None
                        state.promote_entries = []
                        state.promote_pages = []
                        state.promote_boundary = 0
                        state.host_hit_pages = 0
                continue
            with self._lock:
                if self._slots[index] is not state:
                    continue        # cancelled and freed while it copied
            missing = self._dispatch_page_inject(
                state.promote_pages, job.result,
                [entry.entry_id for entry in state.promote_entries]
                if self.mesh is not None else None)
            if missing:
                # a rank lacks a shard of the run: recompute it, as after a
                # failed copy here, and drop the run's entries on every rank
                log.warning("host-kv promotion (slot %d): %d rank(s) lack "
                            "a shard — falling back to recompute", index,
                            missing)
                with self._lock:
                    entries = state.promote_entries
                    if self._slots[index] is state:
                        self.host_kv_fallbacks += 1
                        state.promote_job = None
                        state.promote_entries = []
                        state.promote_pages = []
                        state.promote_boundary = 0
                        state.host_hit_pages = 0
                for entry in entries:
                    self._host_store.discard(entry)
                _HOST_KV_BYTES_USED.set(self._host_store.bytes_used)
                continue
            promoted = len(state.promote_pages)
            now = self.clock()
            finish = False
            with self._lock:
                if self._slots[index] is not state:
                    continue
                state.promote_job = None
                state.promote_entries = []
                state.promote_ms = (now - state.promote_started_ts) * 1e3
                state.prefill_next = max(state.prefill_next,
                                         min(state.promote_boundary,
                                             state.prefill_target))
                self.host_kv_promotions += promoted
                # injected pages are dispatched content: into the radix
                # tree, so the next identical prompt hits on the device
                self._prefix.insert(state.request.prompt,
                                    self._pool.page_table[index],
                                    state.promote_boundary)
                _PREFIX_CACHED_PAGES.set(self._prefix.cached_pages)
                finish = state.prefill_next >= state.prefill_target
            _HOST_KV_PROMOTIONS.inc(promoted)
            if finish:
                self._finish_prefill(index, state)

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
                    _QUEUE_DEPTH.set(len(self._pending))
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
                            evicted = self._prefix.evict(shortfall)
                            if evicted:
                                _PREFIX_EVICTIONS.inc(evicted)
                                _PREFIX_CACHED_PAGES.set(
                                    self._prefix.cached_pages)
                        granted = self._pool.assign_shared(free, shared,
                                                           fresh)
                    else:
                        granted = self._pool.assign(free, needed)
                    if not granted:
                        # strict FIFO: smaller requests never overtake, so
                        # long ones cannot starve (submit() rejected the
                        # impossible)
                        _QUEUE_DEPTH.set(len(self._pending))
                        return joined
                    host_entries: List[HostPageEntry] = []
                    if self._prefix is not None:
                        if cached_tokens > 0:
                            self.prefix_hits += 1
                            _PREFIX_HITS.inc()
                        else:
                            self.prefix_misses += 1
                            _PREFIX_MISSES.inc()
                        if self._host_store is not None:
                            # the host tier can only EXTEND the device
                            # match: resident content keys past the shared
                            # run are promoted into this slot's first
                            # fresh pages instead of recomputed
                            host_entries = self._probe_host_locked(
                                request.prompt, len(shared))
                    _KV_PAGES_FREE.set(self._pool.free_pages)
                    _KV_BYTES_USED.set(self._pool.used_pages
                                       * self._page_bytes)
                    _SLOT_PAGES.labels(slot=str(free)).set(needed)
                self._pending.popleft()
                joined_ts = self.clock()
                self._slots[free] = _Slot(request=request,
                                          joined_ts=joined_ts,
                                          cached_tokens=cached_tokens)
                if self.paged and host_entries:
                    # the promoted run lands in the fresh pages right after
                    # the shared run; the grant is unchanged — promotion
                    # replaces the fill (recompute -> copy), not the pages
                    state = self._slots[free]
                    row = self._pool.owned_pages(free)
                    state.promote_entries = host_entries
                    state.promote_pages = row[
                        len(shared):len(shared) + len(host_entries)]
                    state.promote_boundary = (
                        (len(shared) + len(host_entries)) * self.page_size)
                    state.host_hit_pages = len(host_entries)
                # last legal write position of the speculative windows
                self._pos_limits[free] = (len(request.prompt)
                                          + request.max_new_tokens - 1)
                # the queue phase closes here, apart from TTFT
                queue_wait_s = joined_ts - request.submitted_ts
                _QUEUE_WAIT_SECONDS.observe(queue_wait_s)
                self._queue_wait_hist.observe(queue_wait_s)
                meter = self.tenant_meter
                if meter is not None:
                    # prompt tokens split into what the cache served and
                    # what prefill will compute
                    tenant = request.user_key or ANONYMOUS_TENANT
                    meter.charge_queue(tenant, queue_wait_s)
                    meter.count_tokens(tenant, "cached", cached_tokens)
                    meter.count_tokens(tenant, "prefill",
                                       len(request.prompt) - cached_tokens)
                record = request.record
                if record is not None:
                    record.queue_ms = queue_wait_s * 1e3
                    record.slot = free
                    if self.paged:
                        record.kv_pages = needed
                    if self._prefix is not None:
                        record.cached_tokens = cached_tokens
                get_tracer().record_span(
                    "generate.queue", kind="generate",
                    start_ts=request.submitted_wall,
                    duration_s=queue_wait_s,
                    request_id=request.request_id, slot=free)
                _QUEUE_DEPTH.set(len(self._pending))
                _SLOTS_BUSY.set(self._busy_locked())
            try:
                if self._host_store is not None:
                    # evict() above may have queued spills of the pages it
                    # reclaimed: gather them NOW, before this join's chunks
                    # (or a later join's) can be dispatched at those pages
                    self._dispatch_demotions()
            finally:
                # the slot is granted: join it even when the gather fails,
                # or it would hold its pages unarmed forever. A chunked
                # join dispatches nothing, and the next tick gathers the
                # requeued demotions before any chunk
                self._join(free, request)
            joined += 1

    def _drop_cancelled_pending_locked(self) -> None:
        """Cancelled requests leave the queue, and so do those past their
        deadline (a head-of-line request waiting for pages times out
        instead of waiting forever)."""
        now = self.clock()
        kept: Deque[_Request] = collections.deque()
        for request in self._pending:
            if request.cancelled:
                self._finish_locked(request, outcome="cancelled")
            elif (request.deadline_ts is not None
                    and now >= request.deadline_ts):
                _DEADLINE_TIMEOUTS.labels(phase="queue").inc()
                self._finish_locked(request, outcome="timeout")
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
        with zero chunks. A host-tier hit parks the slot the same way and
        hands the promotion to the copy lane; the pump resumes the prefill
        past the promoted run once the copy has landed."""
        prompt = request.prompt
        prompt_len = len(prompt)
        record = request.record
        if self._use_chunk_prefill:
            state = self._slots[slot]
            state.prefill_target = prompt_len - 1
            state.prefill_next = min(state.cached_tokens,
                                     state.prefill_target)
            state.prefill_done = False
            state.prefill_started_ts = self.clock()
            if state.promote_entries:
                state.promote_started_ts = self.clock()
                # urgent: a request waits on it, a demotion waits on no one
                state.promote_job = self._host_lane.submit(
                    functools.partial(self._stage_promotion,
                                      list(state.promote_entries)),
                    urgent=True)
                return
            if state.prefill_next >= state.prefill_target:
                self._finish_prefill(slot, state)
            return
        if prompt_len > 1:
            width = _prefill_bucket(prompt_len - 1, self.max_len - 1)
            head = np.zeros((1, width), np.int32)
            head[0, :prompt_len - 1] = prompt[:-1]
            started = self.clock()
            try:
                # the draft lane's mirror rides the same dispatch
                self._dispatch_prefill(head, slot, prompt_len - 1)
            except Exception:
                # a failed prefill must not wedge the slot: free it and
                # requeue the request at the head before re-raising
                with self._lock:
                    if (self._slots[slot] is not None
                            and self._slots[slot].request is request):
                        self._free_slot_locked(slot)
                    self._pending.appendleft(request)
                    _QUEUE_DEPTH.set(len(self._pending))
                    _SLOTS_BUSY.set(self._busy_locked())
                raise
            # host dispatch time: the device finishes the work inside the
            # first decode step, which TTFT captures
            prefill_s = self.clock() - started
            if record is not None:
                record.prefill_bucket = width
                record.prefill_compile = _COMPILE_EVENT
                record.prefill_ms = prefill_s * 1e3
            get_tracer().record_span(
                "generate.prefill", kind="generate",
                start_ts=request.wall(started), duration_s=prefill_s,
                request_id=request.request_id, slot=slot, bucket=width,
                compile=_COMPILE_EVENT)
        elif record is not None:
            # single-token prompt: nothing to prefill, the phase is 0
            record.prefill_ms = 0.0
        with self._lock:
            self._tokens[slot] = prompt[-1]
            self._positions[slot] = prompt_len - 1
            self._temps[slot] = request.temperature
            self._active[slot] = True
            # the draft's first catch-up window: just the current token
            self._spec_windows[slot] = [int(prompt[-1])]

    def _advance_prefills(self) -> int:
        """Dispatch ONE prefill chunk for every slot still mid-prefill. A
        cancel or a passed deadline is honored here too, before the chunk,
        so either frees the slot (and its net-releasable pages) without
        arming it — a slot parked on a promotion included. Returns the
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
            deadline = state.request.deadline_ts
            if deadline is not None and self.clock() >= deadline:
                with self._lock:
                    if self._slots[index] is state:
                        _DEADLINE_TIMEOUTS.labels(phase="prefill").inc()
                        self._free_slot_locked(index)
                        self._finish_locked(state.request,
                                            outcome="timeout")
                continue
            if state.promote_job is not None:
                continue        # parked: the copy lane owns the resume
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
        started = self.clock()
        # with the speculative lane, the draft's mirror rides the dispatch
        self._dispatch_chunk_prefill(head, index, start, length)
        state.prefill_ms += (self.clock() - started) * 1e3
        state.prefill_chunks += 1
        state.prefill_compile = _COMPILE_EVENT
        record = request.record
        if record is not None and record.prefill_bucket is None:
            record.prefill_bucket = width
        state.prefill_next = start + length
        with self._lock:
            if self._slots[index] is state:
                self._prefix.insert(prompt, self._pool.page_table[index],
                                    state.prefill_next)
                _PREFIX_CACHED_PAGES.set(self._prefix.cached_pages)
        if state.prefill_next >= state.prefill_target:
            self._finish_prefill(index, state)

    def _finish_prefill(self, index: int, state: _Slot) -> None:
        """Arm a slot whose prefill (possibly zero chunks — a full-prefix
        hit) is dispatched: the next decode step emits its first token.
        Closes the ledger's prefill phase and the prefill span."""
        request = state.request
        record = request.record
        now = self.clock()
        if record is not None:
            record.prefill_ms = state.prefill_ms
            record.prefill_compile = state.prefill_compile
            record.prefill_chunks = state.prefill_chunks
            if self._host_store is not None:
                # the copy's share of TTFT, apart from the prefill's
                record.host_hit_pages = state.host_hit_pages
                if state.host_hit_pages:
                    record.promote_ms = round(state.promote_ms, 3)
        _PREFILL_CHUNKS.observe(state.prefill_chunks)
        if state.prefill_chunks > 0:
            get_tracer().record_span(
                "generate.prefill", kind="generate",
                start_ts=request.wall(state.prefill_started_ts),
                duration_s=now - state.prefill_started_ts,
                request_id=request.request_id, slot=index,
                bucket=(record.prefill_bucket if record is not None
                        else None),
                compile=state.prefill_compile,
                chunks=state.prefill_chunks,
                cached_tokens=state.cached_tokens)
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

    def _run_spec_propose(self, window: np.ndarray, lens: np.ndarray,
                          limits: np.ndarray,
                          page_table: Optional[np.ndarray]) -> torch.Tensor:
        """The draft lane's catch-up and proposals (``[S, k]`` on the
        device); on a serving mesh every rank runs them (``PROPOSE``)."""
        positions = self._positions.copy()

        def body():
            return self._spec.propose(window, lens, positions, limits,
                                      page_table)

        if self.mesh is None:
            return body()
        return self._mesh_command(
            OP_PROPOSE, (), [window, lens, positions, limits]
            + ([page_table] if self.paged else []), body)

    def _run_spec_verify(self, verify_window: np.ndarray, limits: np.ndarray,
                         page_table: Optional[np.ndarray]):
        """The batched target verify over ``[S, k+1]`` window tokens
        (current token + proposals): ``(greedy [S, k+1], chosen [S])`` on
        the device. On a serving mesh every rank runs it (``VERIFY``);
        only rank 0 samples."""
        self._fault_point("verify")
        self.step_dispatches += 1
        positions = self._positions.copy()

        def body():
            return self._verify_device(verify_window, positions,
                                       self._active, self._temps, limits,
                                       page_table)

        if self.mesh is None:
            return body()
        return self._mesh_command(
            OP_VERIFY, (), [verify_window, positions, limits]
            + ([page_table] if self.paged else []), body)

    def _verify_device(self, verify_window: np.ndarray,
                       positions: np.ndarray, active: Optional[np.ndarray],
                       temps: Optional[np.ndarray], limits: np.ndarray,
                       page_table: Optional[np.ndarray]):
        """The verify's device body; a worker passes no ``active``/``temps``
        (it does not sample) and gets None for ``chosen``."""
        if active is None:
            active = np.zeros(self.capacity, bool)
            temps = np.zeros(self.capacity, np.float32)
        operands = (self._operand(verify_window), self._operand(positions),
                    self._operand(active), self._operand(temps),
                    self._operand(limits))
        if self.paged:
            return _paged_spec_verify_body(
                self.params, *operands, self._operand(page_table),
                self._cache, self._generator, self.config, self.top_k,
                self._tp)
        return _spec_verify_body(self.params, *operands, self._cache,
                                 self._generator, self.config, self.top_k,
                                 self._tp)

    def _spec_decode_step(self, marks: Optional[TickMarks] = None) -> int:
        """One speculative tick: draft catch-up + k proposals, ONE batched
        verify over all k+1 positions, then longest-matching-prefix
        acceptance (on a serving mesh: on rank 0 alone; the next tick's
        payloads carry what it decided). Greedy slots emit the target's own greedy tokens (the
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
        if marks is not None:
            # propose, read, verify, read: no one dispatch and one wait,
            # so those two phases stay 0 (the prefills end here)
            marks.dispatch = self.clock()
        # the "step" point covers the propose half of the tick (the verify
        # has its own), outside the lock like every dispatch
        self._fault_point("step")
        proposals = np.asarray(self._run_spec_propose(
            window, lens, limits, page_table).cpu())
        verify_window = np.concatenate([self._tokens[:, None], proposals],
                                       axis=1)
        greedy, chosen = self._run_spec_verify(verify_window, limits,
                                               page_table)
        greedy, chosen = greedy.cpu().numpy(), chosen.cpu().numpy()
        now = self.clock()
        with self._lock:
            self.steps += 1
            _BATCH_EFFICIENCY.observe(len(stepped) / self.capacity)
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
                    if self.tenant_meter is not None:
                        self.tenant_meter.count_tokens(
                            request.user_key or ANONYMOUS_TENANT,
                            "spec_accepted", matched)
                    _SPEC_PROPOSED.inc(self.spec_tokens)
                    # inc(0) still creates the series
                    _SPEC_ACCEPTED.inc(matched)
                    record = request.record
                    if record is not None:
                        record.draft_tokens = ((record.draft_tokens or 0)
                                               + self.spec_tokens)
                        record.accepted_tokens = (
                            (record.accepted_tokens or 0) + matched)
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
            _SLOTS_BUSY.set(self._busy_locked())
        if marks is not None:
            marks.apply, marks.applied = now, self.clock()
        return len(stepped)

    def _decode_step(self, marks: Optional[TickMarks] = None) -> int:
        """The decode step of a tick; with ``marks`` (a recorded tick) it
        samples the boundaries of the dispatch (``_run_step`` until every
        launch is enqueued), the wait (reading the emitted tokens) and the
        apply (every slot's token under the lock)."""
        if self._spec is not None:
            return self._spec_decode_step(marks)
        with self._lock:
            # slots still chunk-prefilling are parked (active False): they
            # join the batch only once armed
            stepped = [(index, slot.request)
                       for index, slot in enumerate(self._slots)
                       if slot is not None and bool(self._active[index])]
        if not stepped:
            return 0
        if marks is None:
            emitted = self._run_step().cpu().numpy()
        else:
            marks.dispatch = self.clock()
            launched = self._run_step()
            marks.wait = self.clock()
            emitted = launched.cpu().numpy()
        now = self.clock()
        with self._lock:
            self.steps += 1
            _BATCH_EFFICIENCY.observe(len(stepped) / self.capacity)
            for index, request in stepped:
                if (self._slots[index] is None
                        or self._slots[index].request is not request):
                    continue        # freed between snapshot and apply
                token = int(emitted[index])
                self._tokens[index] = token
                self._positions[index] += 1
                self._apply_token_locked(index, request, token, now)
            _SLOTS_BUSY.set(self._busy_locked())
        if marks is not None:
            marks.apply, marks.applied = now, self.clock()
        return len(stepped)

    def _apply_token_locked(self, index: int, request: _Request,
                            token: int, now: float) -> None:
        if request.cancelled:
            self._free_slot_locked(index)
            self._finish_locked(request, outcome="cancelled")
            return
        request.generated.append(token)
        self.emitted_tokens += 1
        _TOKENS.inc()
        if self.tenant_meter is not None:
            self.tenant_meter.count_tokens(
                request.user_key or ANONYMOUS_TENANT, "decode", 1)
        record = request.record
        if request.first_token_ts is None:
            request.first_token_ts = now
            ttft = now - request.submitted_ts
            _TTFT_SECONDS.observe(ttft)
            self._ttft_hist.observe(ttft)
            if record is not None:
                record.ttft_ms = ttft * 1e3
        else:
            gap = now - (request.last_token_ts or now)
            _INTERTOKEN_SECONDS.observe(gap)
            self._intertoken_hist.observe(gap)
            if record is not None:
                record._gaps_ms.append(gap * 1e3)
        request.last_token_ts = now
        if record is not None:
            record.tokens = len(request.generated)
        if request.handle is not None:
            request.handle._push(TOKEN, token)
        hit_eos = self.eos_token is not None and token == self.eos_token
        if hit_eos or len(request.generated) >= request.max_new_tokens:
            self._free_slot_locked(index)
            self._finish_locked(request, outcome="completed")
        elif (request.deadline_ts is not None
                and now >= request.deadline_ts):
            # mid-decode deadline: truncate AFTER delivering this token
            _DEADLINE_TIMEOUTS.labels(phase="decode").inc()
            self._free_slot_locked(index)
            self._finish_locked(request, outcome="timeout")

    def _free_slot_locked(self, index: int) -> None:
        """Free the slot. Paged: release its grant NOW through the
        refcounted pool (pages still shared with other slots or held by the
        prefix cache survive; the rest may be reassigned on the next
        admission), so the row points back at the trash page and the
        position resets to 0 — the parked slot's writes land at (trash,
        0). Contiguous: the position stays frozen, so the parked slot's
        writes keep landing on one consumed cell of its own row. With the
        host tier, the slot's prefix pages that no one else holds are
        queued for demotion first."""
        state = self._slots[index]
        if self._host_store is not None and state is not None:
            self._queue_slot_demotions_locked(index, state)
        self._slots[index] = None
        self._active[index] = False
        self._spec_windows[index] = []
        # speculative writes to a freed slot must not land (the contiguous
        # layout keeps its position frozen: the limit is its only guard)
        self._pos_limits[index] = -1
        if self.paged:
            self._pool.release(index)
            self._positions[index] = 0
            _KV_PAGES_FREE.set(self._pool.free_pages)
            _KV_BYTES_USED.set(self._pool.used_pages * self._page_bytes)
            _SLOT_PAGES.labels(slot=str(index)).set(0)

    def _finish_locked(self, request: _Request, outcome: str,
                       error: Optional[str] = None) -> None:
        """Terminal bookkeeping, exactly once per request. With ``error``
        the handle gets an ERROR event (the stream's terminal error);
        otherwise a DONE summary carrying ``outcome`` (completed,
        cancelled, timeout)."""
        if request.finished:
            return
        request.finished = True
        now = self.clock()
        _REQUESTS.labels(outcome=outcome).inc()
        if outcome == "completed":
            self.completed_requests += 1
        if request.user_key:
            remaining = self._user_active.get(request.user_key, 1) - 1
            if remaining <= 0:
                self._user_active.pop(request.user_key, None)
            else:
                self._user_active[request.user_key] = remaining
        record = request.record
        if record is not None:
            if (request.first_token_ts is not None
                    and request.last_token_ts is not None):
                record.decode_ms = (request.last_token_ts
                                    - request.first_token_ts) * 1e3
            record.total_ms = (now - request.submitted_ts) * 1e3
            if self.tenant_meter is not None:
                # the meter's per-request integrals onto the row
                record.device_seconds = request.device_seconds
                record.kv_byte_seconds = request.kv_byte_seconds
            get_request_ledger().finish(record, outcome,
                                        finished_ts=request.wall(now))
        if request.first_token_ts is not None:
            # the decode span closes with the request (a request that never
            # produced a token has nothing its row does not carry)
            get_tracer().record_span(
                "generate.decode", kind="generate",
                start_ts=request.wall(request.first_token_ts),
                duration_s=(request.last_token_ts
                            - request.first_token_ts),
                request_id=request.request_id,
                tokens=len(request.generated), outcome=outcome)
        if request.handle is None:
            return
        if error is not None:
            request.handle._push(ERROR, error)
            return
        request.handle._push(DONE, {
            "requestId": request.request_id,
            "tokens": list(request.generated),
            "outcome": outcome,
            "ttftS": (round(request.first_token_ts - request.submitted_ts, 6)
                      if request.first_token_ts is not None else None),
            "durationS": round(now - request.submitted_ts, 6),
        })

    def fail_all_inflight(self, message: str) -> int:
        """Fail every queued and running request with a terminal error
        event — what a supervisor calls when a failure is fatal, before
        rebuilding the engine, so no stream waits on a dead device. Returns
        how many requests were failed. Touches only host bookkeeping."""
        with self._lock:
            failed = 0
            for request in list(self._pending):
                self._finish_locked(request, outcome="failed", error=message)
                failed += 1
            self._pending.clear()
            for index, slot in enumerate(self._slots):
                if slot is None:
                    continue
                self._free_slot_locked(index)
                self._finish_locked(slot.request, outcome="failed",
                                    error=message)
                failed += 1
            _QUEUE_DEPTH.set(0)
            _SLOTS_BUSY.set(0)
            return failed

    def release(self) -> None:
        """Drop the device state (weights, KV cache, the draft lane, the
        step graph, the copy stream and its pinned staging) of an engine
        that will not run again — what a supervisor calls after failing it
        fast — and the host tier's payloads, and end its copy lane's
        thread. Handles that clients still hold, and the fault's traceback,
        keep the engine object alive, but no longer its memory. Host
        bookkeeping (stats' counters, the ledger rows) stays readable. The
        controller of a serving mesh has its workers release theirs too
        (``RELEASE``: their draft lanes, staging, shards and lane threads),
        and a rebuilt engine's ``BUILD`` brings them back."""
        if (self.mesh is not None and self.mesh.is_controller
                and self.params is not None and not self.mesh.broken
                and self._mesh_build == self.mesh.builds):
            self._mesh_command(OP_RELEASE)
        with self._lock:
            self.params = None
            self._cache = None
            self._spec = None
            if self._step_graph is not None:
                self._step_graph.close()
            self._copy_stream = None
            self._staging = ()
            self._host_shards = {}
            self._shard_jobs = []
            self._demote_jobs = []
            if self._host_store is not None:
                self._host_store.clear()
        if isinstance(self._host_lane, HostCopyLane):
            self._host_lane.close()

    # -- introspection ----------------------------------------------------
    def _busy_locked(self) -> int:
        return sum(1 for slot in self._slots if slot is not None)

    def stats(self) -> Dict:
        """Engine snapshot: the JAX engine's ``stats`` under the same key
        names (``meshShape`` "dp x tp" and ``numDevices`` dp·tp;
        ``busySlotSeconds`` null without a tenant meter).
        ``device``, ``stepDispatches``, ``stepGraphCaptures``,
        ``stepGraphReplays`` and ``prefills`` are the port's own."""
        def ms(value: Optional[float]) -> Optional[float]:
            return None if value is None else round(value * 1e3, 3)

        store = self._host_store
        with self._lock:
            lookups = self.prefix_hits + self.prefix_misses
            return {
                "slots": self.capacity,
                "slotsBusy": self._busy_locked(),
                "queueDepth": len(self._pending),
                "queueCapacity": self.queue_depth,
                "draining": self._draining,
                "maxSeqLen": self.max_len,
                "meshShape": self.mesh_shape,
                "numDevices": self.num_devices,
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
                "hostKvBytes": (self.host_kv_bytes if store is not None
                                else None),
                "hostPagesResident": (store.resident_pages
                                      if store is not None else None),
                "hostBytesUsed": (store.bytes_used if store is not None
                                  else None),
                "hostHitRate": (
                    round(self.host_kv_hits
                          / (self.host_kv_hits + self.host_kv_misses), 4)
                    if store is not None
                    and self.host_kv_hits + self.host_kv_misses else None),
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
                "busySlotSeconds": (round(self.busy_slot_seconds, 6)
                                    if self.tenant_meter is not None
                                    else None),
                "stepDispatches": self.step_dispatches,
                "stepGraphCaptures": (self._step_graph.captures
                                      if self._step_graph is not None
                                      else 0),
                "stepGraphReplays": (self._step_graph.replays
                                     if self._step_graph is not None
                                     else 0),
                "prefills": self.prefills,
                "ttftP50Ms": ms(self._ttft_hist.quantile(0.5)),
                "ttftP95Ms": ms(self._ttft_hist.quantile(0.95)),
                "intertokenP50Ms": ms(self._intertoken_hist.quantile(0.5)),
                "intertokenP95Ms": ms(self._intertoken_hist.quantile(0.95)),
            }

    def ttft_p95_s(self) -> Optional[float]:
        return self._ttft_hist.quantile(0.95)

    def queue_wait_p95_s(self) -> Optional[float]:
        """p95 admission-queue wait (None before the first join)."""
        return self._queue_wait_hist.quantile(0.95)

    def queue_saturation(self) -> float:
        with self._lock:
            return len(self._pending) / self.queue_depth

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
