"""Speculative decoding lane — the PyTorch counterpart of
``tensorhive_tpu/serving/speculative.py``: draft proposals, one batched
verify, exact accept.

A small DRAFT model proposes ``spec_tokens`` (k) greedy continuations per
slot per tick from its own KV lane, and the TARGET model verifies all
``k + 1`` positions in ONE batched window pass. Acceptance is the longest
matching prefix of (proposal, target greedy) pairs, so the emitted stream
is always the target's own greedy tokens: greedy speculative output equals
greedy non-speculative output whatever the draft proposes. A bad draft
costs time, never correctness.

The design is the JAX module's:

* The draft KV cache is a second physical array (``[draft_layers, pages,
  page_size, kv_heads, d_head]``, int8 + scales under ``kv_quant``; or
  ``[draft_layers, slots, max_len, ...]`` for the contiguous layout) read
  through the SAME page tables as the target's: no second allocator. The
  draft mirrors every target prefill (whole-prompt or chunk) through the
  same table row, so a prefix-cache page carries both lanes' K/V.
* Each tick the draft first re-processes the tokens accepted last tick (a
  right-aligned catch-up window ending at the slot's position), which
  overwrites its own speculative K/V, then rolls k proposals. Rejected
  positions need no scrub in either lane: they sit past the slot's
  position and are rewritten before anything attends them.
* Sampled slots do not speculate: they take one token per tick from the
  verify pass's position 0 (``_choose_next``), so the generator advances
  once per tick, not once per token, and sampled streams differ from the
  non-speculative engine's (greedy is unaffected).

Eager PyTorch, like the engine: the caches are written IN PLACE. Two
differences in form from the JAX module, none in the tokens or counters:

* JAX drops invalid window and draft-step writes (``mode="drop"`` on page
  ``num_physical``, one past the pool). Here that page exists: a paged
  cache of a speculative engine holds one physical page more than the pool
  (:func:`drop_page`), which no page table names, and the writes JAX drops
  land there — sync-free, where a boolean mask would make the device
  report to the host, and within the page ids ``kvq.step_write`` takes.
  The trash page is NOT used for them: a window that runs past a slot's
  limit reads positions past its grant, which its row maps to the trash
  page, and the verify's greedy tokens there (never emitted, but compared
  with the proposals) must see what JAX's see. The int8 row merge takes a
  validity mask and writes nothing for invalid cells, as in JAX. The
  contiguous layout has no spare cell, so its writes are masked with
  ``torch.where`` on the slot's own row, one window column at a time.
* The draft step attends through ``paged_attention``: the CUDA kernel on
  the card, its plain version on the CPU, as the port's decode step does
  (JAX's draft step takes the XLA gather there). The catch-up and verify
  windows attend in plain PyTorch (:func:`_window_attend`), as in JAX.

On a serving mesh every body takes the engine's tensor-parallel hooks
(``tp``, a ``parallel.mesh.TensorParallel``), as the target's step does:
the vocab-sharded embedding, the row-parallel sums of ``wo`` and the MLP
down projection, the logits assembled over tp before every greedy argmax
(so every rank proposes and verifies the same tokens) and, under the GQA
guard, the attention on every head. The draft holds its own shard by its
own rules (``parallel.mesh.shard_model``): a self-draft the first blocks of
the target's shard, a preset draft its slice of the seeded whole; its
cache holds the rank's KV heads of the draft.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.decode import KVCache, QuantKVCache
from ..models.transformer import (
    PRESETS,
    Params,
    TransformerConfig,
    TransformerLM,
    _lm_head,
    _rmsnorm,
)
from ..ops import kv_quant as kvq
from ..ops.flash_attention import NEG_INF
from ..ops.paged_attention import decode_attention, paged_attention
from ..parallel.mesh import (
    TensorParallel,
    kernel_cache_spec,
    local_shape,
    shard_model,
)


def resolve_speculative(mode: str, device: torch.device) -> str:
    """Resolve the ``speculative = auto|on|off`` knob once at engine
    construction: ``auto`` turns the lane on where the engine runs on the
    card and leaves it off on the CPU — JAX's rule, with "a real TPU
    backend" read as the card."""
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"speculative must be auto|on|off, got {mode!r}")
    if mode != "auto":
        return mode
    return "on" if torch.device(device).type == "cuda" else "off"


def build_draft(params: Params, config: TransformerConfig,
                draft_preset: str = "", draft_layers: int = 0
                ) -> Tuple[Params, TransformerConfig, bool]:
    """The draft model: ``(draft_params, draft_config, shares_target)``.

    Self-draft (no preset): the target's first ``draft_layers`` blocks
    (default half, at least 1), with ``tok_embed``, ``final_norm`` and
    ``w_lm_head`` the SAME tensors, so the lane costs no parameter bytes.
    ``draft_layers = n_layers`` makes the draft the target (every proposal
    accepted). A ``draft_preset`` builds an independent model of that
    preset, which must share the vocabulary, with random weights from a
    ``torch.Generator`` seeded 7 on the target's device."""
    if draft_preset:
        if draft_preset not in PRESETS:
            raise ValueError(
                f"draft_preset {draft_preset!r} unknown; choose from "
                f"{sorted(PRESETS)}")
        base = PRESETS[draft_preset]
        if base.vocab_size != config.vocab_size:
            raise ValueError(
                f"draft_preset {draft_preset!r} has vocab "
                f"{base.vocab_size}, the target serves {config.vocab_size} "
                "— speculative proposals are token ids, the tokenizers "
                "must match")
        draft_config = dataclasses.replace(
            base, dtype=config.dtype, remat=config.remat,
            max_seq_len=max(base.max_seq_len, config.max_seq_len),
            causal=True)
        device = params["tok_embed"].device
        draft_params = TransformerLM.init(
            draft_config, torch.Generator(device=device).manual_seed(7),
            device=device)
        return draft_params, draft_config, False
    layers = int(draft_layers) or max(1, config.n_layers // 2)
    if not 1 <= layers <= config.n_layers:
        raise ValueError(
            f"draft_layers must be in [1, {config.n_layers}], got {layers}")
    draft_config = dataclasses.replace(config, n_layers=layers)
    draft_params = {
        "tok_embed": params["tok_embed"],
        "blocks": list(params["blocks"][:layers]),
        "final_norm": params["final_norm"],
        "w_lm_head": params["w_lm_head"],
    }
    return draft_params, draft_config, True


def _window_attend(q: torch.Tensor, k_ctx: torch.Tensor, v_ctx: torch.Tensor,
                   q_positions: torch.Tensor) -> torch.Tensor:
    """Attention for a ``[S, W]`` token window against each slot's whole
    logical context: ``decode_attention`` widened from one query per slot
    to W — the same grouped einsum, ``NEG_INF`` mask, f32 softmax and
    probabilities rounded to the value dtype, so at W = 1 the two agree
    bitwise. ``q`` [S, W, H, Dh]; ``k_ctx``/``v_ctx`` [S, K, Hkv, Dh] (the
    slot's gathered page run or its contiguous row); ``q_positions`` [S, W]
    absolute positions: query w attends key p only where ``p <= w``."""
    num_slots, width, heads, d_head = q.shape
    kv_heads = k_ctx.shape[2]
    group = heads // kv_heads
    scale = d_head ** -0.5
    q_grouped = q.reshape(num_slots, width, kv_heads, group, d_head)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q_grouped.to(torch.float32),
                          k_ctx.to(torch.float32)) * scale
    key_positions = torch.arange(k_ctx.shape[1], device=q.device)
    mask = (key_positions[None, None, None, None, :]
            <= q_positions[:, None, None, :, None])
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd",
                       probs.to(v_ctx.dtype).to(torch.float32),
                       v_ctx.to(torch.float32))
    return out.reshape(num_slots, width, heads, d_head).to(q.dtype)


def _head_logits(params: Params, x: torch.Tensor,
                 config: TransformerConfig,
                 tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Final norm + LM head over a ``[S, W, D]`` trunk output: f32 logits
    ``[S, W, V]``, the ``_choose_next`` tail widened to a window (the
    vocab-sharded columns assembled over tp)."""
    x = _rmsnorm(x, params["final_norm"]["scale"])
    logits = _lm_head(x, params["w_lm_head"], config.dtype)
    return logits if tp is None else tp.logits(logits)


def drop_page(cache) -> int:
    """The page id that takes the writes JAX drops: the last physical page
    of a speculative engine's paged cache (``num_physical`` in JAX), one
    past the pool's, never named by a page table."""
    return cache.k.shape[1] - 1


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _window_cells(positions: torch.Tensor, width: int, first: int,
                  limit: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absolute positions ``[S, W]`` of a window whose column 0 sits at
    ``positions + first``, and the same clamped into ``[0, limit]``."""
    columns = torch.arange(width, dtype=torch.int32, device=positions.device)
    global_positions = positions[:, None] + first + columns[None, :]
    return global_positions, torch.clamp(global_positions, 0, limit)


# -- paged writes -------------------------------------------------------------

def _paged_window_write(cache, layer: int, page_tables: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor,
                        safe_pos: torch.Tensor, valid: torch.Tensor,
                        dtype: torch.dtype):
    """Write a ``[S, W]`` window's K/V through the page tables (invalid
    cells to the drop page, or left out by the int8 row merge) and return
    each slot's post-write logical context ``[S, K, Hkv, Dh]``."""
    page_size = cache.k.shape[2]
    num_slots, max_pages = page_tables.shape
    if isinstance(cache, QuantKVCache):
        _, _, ctx_k = kvq.row_merge(cache.k[layer], cache.k_scale[layer],
                                    page_tables, k, safe_pos, valid, dtype)
        _, _, ctx_v = kvq.row_merge(cache.v[layer], cache.v_scale[layer],
                                    page_tables, v, safe_pos, valid, dtype)
        return ctx_k, ctx_v
    long_pos = safe_pos.long()
    rows = torch.take_along_dim(page_tables.long(), long_pos // page_size,
                                dim=1)
    pages = torch.where(valid, rows, drop_page(cache))
    offsets = long_pos % page_size
    cache.k[layer][pages, offsets] = k.to(cache.k.dtype)
    cache.v[layer][pages, offsets] = v.to(cache.v.dtype)
    table = page_tables.long()
    window = max_pages * page_size
    ctx_k = cache.k[layer][table].reshape(num_slots, window,
                                          *cache.k.shape[3:])
    ctx_v = cache.v[layer][table].reshape(num_slots, window,
                                          *cache.v.shape[3:])
    return ctx_k, ctx_v


def _paged_draft_step(params: Params, token: torch.Tensor,
                      step_positions: torch.Tensor, limits: torch.Tensor,
                      page_tables: torch.Tensor, cache,
                      config: TransformerConfig,
                      tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """One greedy draft step at per-slot positions over the paged draft
    cache: write the token's K/V through the page-table row (positions past
    ``limits`` to the drop page), attend through ``paged_attention`` and
    return the argmax. The engine's ``_paged_step_body`` minus sampling,
    int8 pages included."""
    from .engine import _embed, _on_heads, _reducers

    page_size = cache.k.shape[2]
    max_pages = page_tables.shape[1]
    slot_ids = torch.arange(token.shape[0], device=token.device)
    safe = torch.clamp(step_positions, 0, max_pages * page_size - 1).long()
    rows = page_tables[slot_ids, safe // page_size].long()
    pages = torch.where(step_positions <= limits, rows, drop_page(cache))
    offsets = safe % page_size
    quant = isinstance(cache, QuantKVCache)
    x = _embed(params, token, tp)[:, None, :]
    rope_positions = step_positions[:, None]

    def attend(q, k, v, layer):
        if quant:
            kvq.step_write(cache.k[layer], cache.k_scale[layer], pages,
                           offsets, k[:, 0])
            kvq.step_write(cache.v[layer], cache.v_scale[layer], pages,
                           offsets, v[:, 0])
        else:
            cache.k[layer][pages, offsets] = k[:, 0].to(cache.k.dtype)
            cache.v[layer][pages, offsets] = v[:, 0].to(cache.v.dtype)
        return _on_heads(tp, q, lambda q: paged_attention(
            q, cache.k[layer], cache.v[layer], page_tables, step_positions,
            k_scales=cache.k_scale[layer] if quant else None,
            v_scales=cache.v_scale[layer] if quant else None))

    for layer_index, block in enumerate(params["blocks"]):
        x = TransformerLM.block_forward(x, block, config, rope_positions,
                                        attend, layer_index=layer_index,
                                        **_reducers(tp))
    return _greedy(_head_logits(params, x, config, tp)[:, 0])


def _paged_draft_propose_body(params: Params, window_tokens: torch.Tensor,
                              window_lens: torch.Tensor,
                              positions: torch.Tensor, limits: torch.Tensor,
                              page_tables: torch.Tensor, cache,
                              config: TransformerConfig,
                              tp: Optional[TensorParallel] = None
                              ) -> torch.Tensor:
    """Catch the draft lane up on last tick's accepted tokens, then propose
    ``k = W - 1`` greedy continuations per slot: ``[S, k]`` int32.

    ``window_tokens`` [S, W] is RIGHT-ALIGNED: column ``W-1`` is the slot's
    current token at ``positions[s]``; only the last ``window_lens[s]``
    columns are real. Phase A writes their K/V through the page table
    (overwriting last tick's speculative writes — the draft lane's whole
    rollback) and attends the post-write context; its last column's argmax
    is proposal 1. Phase B rolls k - 1 single-token steps through
    ``paged_attention``. Padding and positions past ``limits`` write only
    the drop page (int8 window: nothing)."""
    from .engine import _embed, _on_heads, _reducers

    width = window_tokens.shape[1]
    page_size = cache.k.shape[2]
    window_ctx = page_tables.shape[1] * page_size
    global_positions, safe_pos = _window_cells(positions, width,
                                               1 - width, window_ctx - 1)
    columns = torch.arange(width, device=positions.device)
    valid = ((columns[None, :] >= width - window_lens[:, None])
             & (global_positions >= 0)
             & (global_positions <= limits[:, None]))
    x = _embed(params, window_tokens, tp)

    def attend(q, k, v, layer):
        ctx_k, ctx_v = _paged_window_write(cache, layer, page_tables, k, v,
                                           safe_pos, valid, config.dtype)
        return _on_heads(tp, q, lambda q: _window_attend(q, ctx_k, ctx_v,
                                                         safe_pos))

    for layer_index, block in enumerate(params["blocks"]):
        x = TransformerLM.block_forward(x, block, config, safe_pos, attend,
                                        layer_index=layer_index,
                                        **_reducers(tp))
    token = _greedy(_head_logits(params, x[:, -1:], config, tp)[:, 0])
    proposals = [token]
    for step in range(1, width - 1):
        token = _paged_draft_step(params, token, positions + step, limits,
                                  page_tables, cache, config, tp)
        proposals.append(token)
    return torch.stack(proposals, dim=1)


# -- contiguous writes --------------------------------------------------------

def _row_write(cache: KVCache, layer: int, slot_ids: torch.Tensor,
               column_pos: torch.Tensor, writable: torch.Tensor,
               k: torch.Tensor, v: torch.Tensor) -> None:
    """Write one position per slot into its contiguous row where
    ``writable``, keeping the cell's value elsewhere (the JAX module's
    out-of-bounds drop; a row has no spare cell to send it to)."""
    keep = writable[:, None, None]
    for tensor, value in ((cache.k[layer], k), (cache.v[layer], v)):
        current = tensor[slot_ids, column_pos]
        tensor[slot_ids, column_pos] = torch.where(
            keep, value.to(tensor.dtype), current)


def _contiguous_window_write(cache: KVCache, layer: int, k: torch.Tensor,
                             v: torch.Tensor, safe_pos: torch.Tensor,
                             valid: torch.Tensor) -> None:
    """A ``[S, W]`` window into each slot's row, one column at a time:
    clamped cells of one row can name the same position, and a column
    written after another sees its write, as the JAX scatter's in-order
    drop does."""
    slot_ids = torch.arange(k.shape[0], device=k.device)
    long_pos = safe_pos.long()
    for column in range(k.shape[1]):
        _row_write(cache, layer, slot_ids, long_pos[:, column],
                   valid[:, column], k[:, column], v[:, column])


def _draft_step(params: Params, token: torch.Tensor,
                step_positions: torch.Tensor, limits: torch.Tensor,
                cache: KVCache, config: TransformerConfig,
                tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Contiguous twin of :func:`_paged_draft_step`: the write lands at
    ``(slot, position)`` of the slot's own row (past ``limits``: kept as
    it was) and the attend is the plain masked decode attention."""
    from .engine import _embed, _on_heads, _reducers

    max_len = cache.k.shape[2]
    slot_ids = torch.arange(token.shape[0], device=token.device)
    safe = torch.clamp(step_positions, 0, max_len - 1).long()
    writable = step_positions <= limits
    x = _embed(params, token, tp)[:, None, :]
    rope_positions = step_positions[:, None]

    def attend(q, k, v, layer):
        _row_write(cache, layer, slot_ids, safe, writable, k[:, 0], v[:, 0])
        return _on_heads(tp, q, lambda q: decode_attention(
            q, cache.k[layer], cache.v[layer],
            step_positions[:, None, None, None, None]))

    for layer_index, block in enumerate(params["blocks"]):
        x = TransformerLM.block_forward(x, block, config, rope_positions,
                                        attend, layer_index=layer_index,
                                        **_reducers(tp))
    return _greedy(_head_logits(params, x, config, tp)[:, 0])


def _draft_propose_body(params: Params, window_tokens: torch.Tensor,
                        window_lens: torch.Tensor, positions: torch.Tensor,
                        limits: torch.Tensor, cache: KVCache,
                        config: TransformerConfig,
                        tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Contiguous twin of :func:`_paged_draft_propose_body`: the same
    window and phases, writes into each slot's row, whose post-write state
    is the attend context (no gather)."""
    from .engine import _embed, _on_heads, _reducers

    width = window_tokens.shape[1]
    max_len = cache.k.shape[2]
    global_positions, safe_pos = _window_cells(positions, width,
                                               1 - width, max_len - 1)
    columns = torch.arange(width, device=positions.device)
    valid = ((columns[None, :] >= width - window_lens[:, None])
             & (global_positions >= 0)
             & (global_positions <= limits[:, None]))
    x = _embed(params, window_tokens, tp)

    def attend(q, k, v, layer):
        _contiguous_window_write(cache, layer, k, v, safe_pos, valid)
        return _on_heads(tp, q, lambda q: _window_attend(
            q, cache.k[layer], cache.v[layer], safe_pos))

    for layer_index, block in enumerate(params["blocks"]):
        x = TransformerLM.block_forward(x, block, config, safe_pos, attend,
                                        layer_index=layer_index,
                                        **_reducers(tp))
    token = _greedy(_head_logits(params, x[:, -1:], config, tp)[:, 0])
    proposals = [token]
    for step in range(1, width - 1):
        token = _draft_step(params, token, positions + step, limits, cache,
                            config, tp)
        proposals.append(token)
    return torch.stack(proposals, dim=1)


# -- target verify ------------------------------------------------------------

def _paged_spec_verify_body(params: Params, window_tokens: torch.Tensor,
                            positions: torch.Tensor, active: torch.Tensor,
                            temps: torch.Tensor, limits: torch.Tensor,
                            page_tables: torch.Tensor, cache,
                            generator: Optional[torch.Generator],
                            config: TransformerConfig,
                            top_k: Optional[int],
                            tp: Optional[TensorParallel] = None
                            ) -> Tuple[torch.Tensor,
                                       Optional[torch.Tensor]]:
    """Verify all ``k + 1`` window positions in one batched target pass.

    ``window_tokens`` [S, W] is LEFT-ALIGNED: column 0 is the slot's
    current token at ``positions[s]``, columns 1..k the draft proposals.
    Every column's K/V is written through the page table (past ``limits``:
    the drop page, int8: nothing), each slot's page run is read in
    logical order and :func:`_window_attend` applies the positional mask.
    Returns ``(greedy, chosen)``: the target's greedy token at EVERY
    column (``greedy[s, j]`` is the token for position ``positions[s] + j
    + 1`` given the true prefix and proposals 1..j, which is what the
    sequential step would emit) and ``_choose_next``'s pick for column 0
    (greedy or sampled; the sampled slots' one token per tick). A mesh
    worker (no ``generator``) gets None for ``chosen``."""
    from .engine import _choose_next, _embed, _on_heads, _reducers

    width = window_tokens.shape[1]
    window_ctx = page_tables.shape[1] * cache.k.shape[2]
    global_positions, safe_pos = _window_cells(positions, width, 0,
                                               window_ctx - 1)
    writable = global_positions <= limits[:, None]
    x = _embed(params, window_tokens, tp)

    def attend(q, k, v, layer):
        ctx_k, ctx_v = _paged_window_write(cache, layer, page_tables, k, v,
                                           safe_pos, writable, config.dtype)
        return _on_heads(tp, q, lambda q: _window_attend(q, ctx_k, ctx_v,
                                                         safe_pos))

    for layer_index, block in enumerate(params["blocks"]):
        x = TransformerLM.block_forward(x, block, config, safe_pos, attend,
                                        layer_index=layer_index,
                                        **_reducers(tp))
    chosen = _choose_next(params, x[:, :1], window_tokens[:, 0], active,
                          temps, generator, config, top_k, tp)
    return _greedy(_head_logits(params, x, config, tp)), chosen


def _spec_verify_body(params: Params, window_tokens: torch.Tensor,
                      positions: torch.Tensor, active: torch.Tensor,
                      temps: torch.Tensor, limits: torch.Tensor,
                      cache: KVCache, generator: Optional[torch.Generator],
                      config: TransformerConfig, top_k: Optional[int],
                      tp: Optional[TensorParallel] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Contiguous twin of :func:`_paged_spec_verify_body`: the window's
    K/V go into each slot's row (past ``limits`` — a freed slot's limit is
    -1 — the row keeps its cells) and the attend context is the row."""
    from .engine import _choose_next, _embed, _on_heads, _reducers

    width = window_tokens.shape[1]
    max_len = cache.k.shape[2]
    global_positions, safe_pos = _window_cells(positions, width, 0,
                                               max_len - 1)
    writable = global_positions <= limits[:, None]
    x = _embed(params, window_tokens, tp)

    def attend(q, k, v, layer):
        _contiguous_window_write(cache, layer, k, v, safe_pos, writable)
        return _on_heads(tp, q, lambda q: _window_attend(
            q, cache.k[layer], cache.v[layer], safe_pos))

    for layer_index, block in enumerate(params["blocks"]):
        x = TransformerLM.block_forward(x, block, config, safe_pos, attend,
                                        layer_index=layer_index,
                                        **_reducers(tp))
    chosen = _choose_next(params, x[:, :1], window_tokens[:, 0], active,
                          temps, generator, config, top_k, tp)
    return _greedy(_head_logits(params, x, config, tp)), chosen


# -- the lane -----------------------------------------------------------------

class SpeculativeLane:
    """The draft side of the speculative engine: draft params and config,
    the draft KV cache (the target's layout, read through the same page
    tables), the mirrors of the engine's prefills and the per-tick
    proposals. Only the engine's stepping thread calls it (on a serving
    mesh: the controller's pump, and each worker's command loop)."""

    def __init__(self, engine, draft_params: Params,
                 draft_config: TransformerConfig,
                 shares_target: bool) -> None:
        self._engine = engine
        self.draft_config = draft_config
        self.shares_target = shares_target
        #: the draft's tensor-parallel hooks (None without a mesh or at tp
        #: 1); under a mesh the draft holds its own shard by its own rules
        self._tp: Optional[TensorParallel] = None
        self._rules = None
        if engine.mesh is not None:
            self._rules, draft_params, self._tp = shard_model(
                draft_params, draft_config, engine.mesh,
                sharded=shares_target)
        self.params = draft_params
        layers, device = draft_config.n_layers, engine.device
        if engine.paged:
            # one page past the pool (dp trash pages included): the drop
            # page (drop_page), at the same index on every rank
            shape = (layers, engine._pool.physical_pages + 1,
                     engine.page_size, draft_config.kv_heads,
                     draft_config.d_head)
        else:
            shape = (layers, engine.capacity, engine.max_len,
                     draft_config.kv_heads, draft_config.d_head)
        if engine.mesh is not None:
            # this rank's KV heads of the draft, by the draft's own rules
            # (the pool whole, as the target's)
            shape = local_shape(shape, kernel_cache_spec(self._rules),
                                engine.mesh.axis_sizes)
        if engine._quant:
            # int8 pages + scales like the target lane's, behind the same
            # page tables
            scale_shape = (layers, shape[1], shape[3])
            self.cache = QuantKVCache(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                k_scale=torch.zeros(scale_shape, dtype=torch.float32,
                                    device=device),
                v_scale=torch.zeros(scale_shape, dtype=torch.float32,
                                    device=device))
        else:
            self.cache = KVCache(
                k=torch.zeros(shape, dtype=draft_config.dtype, device=device),
                v=torch.zeros(shape, dtype=draft_config.dtype, device=device))

    @property
    def kv_cache_bytes(self) -> int:
        """Device bytes of the draft KV cache (payload + scales)."""
        return sum(t.numel() * t.element_size() for t in self.cache)

    def prefill(self, head: np.ndarray, slot: int, real_len: int,
                row: Optional[np.ndarray]) -> None:
        """Mirror one whole-prompt prefill into the draft lane: the same
        head and slot row (``row``, the slot's page-table row on the paged
        layout), the draft params, config and cache."""
        from .engine import _paged_prefill_body, _prefill_body

        engine = self._engine
        if engine.paged:
            _paged_prefill_body(self.params, engine._operand(head),
                                self.cache, engine._operand(row),
                                int(real_len), self.draft_config, self._tp)
        else:
            _prefill_body(self.params, engine._operand(head), self.cache,
                          int(slot), int(real_len), self.draft_config,
                          self._tp)

    def chunk_prefill(self, head: np.ndarray, start: int, real_len: int,
                      row: np.ndarray) -> None:
        """Mirror one prefill chunk into the draft lane through the slot's
        page-table ``row`` — dispatched right after the target's chunk and
        BEFORE the radix tree adopts its pages, so a cached page carries
        both lanes' K/V."""
        from .engine import _paged_chunk_prefill_body

        engine = self._engine
        _paged_chunk_prefill_body(
            self.params, engine._operand(head), self.cache,
            engine._operand(row), int(start), int(real_len),
            self.draft_config, self._tp)

    def propose(self, window: np.ndarray, lens: np.ndarray,
                positions: np.ndarray, limits: np.ndarray,
                page_table: Optional[np.ndarray]) -> torch.Tensor:
        """Catch up on last tick's accepted tokens and roll ``spec_tokens``
        proposals per slot: ``[S, k]`` int32 on the engine's device."""
        engine = self._engine
        engine.draft_dispatches += 1
        operands = [engine._operand(array)
                    for array in (window, lens, positions, limits)]
        if engine.paged:
            return _paged_draft_propose_body(
                self.params, *operands, engine._operand(page_table),
                self.cache, self.draft_config, self._tp)
        return _draft_propose_body(self.params, *operands, self.cache,
                                   self.draft_config, self._tp)
