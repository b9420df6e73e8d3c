"""Int8 KV-page quantization — the PyTorch counterpart of
``tensorhive_tpu/ops/kv_quant.py`` (write and read primitives, and the
host tier's page gather and scatter).

Same scheme, same bytes: symmetric int8 with one f32 scale per (physical
page, kv_head), scale = max(running max, amax / 127, 1e-8), rescale-on-
write with the whole touched page requantized, and a write that touches a
page's offset-0 cell rebasing the running max at 0. ``torch.round`` and
``jnp.round`` both round half to even, and the clip and floor match, so
payloads and scales come out byte-identical to the JAX functions.

Two differences in form, none in values:

* JAX returns new arrays; ``step_write``, ``row_merge`` and
  ``inject_pages`` here update ``pages_i8``/``scales`` IN PLACE (and
  return them), so the engine writes one layer's pages of its cache
  without copying the layer.
* JAX drops out-of-range scatter indices (``mode="drop"``); torch has no
  such mode. ``row_merge`` masks its indices before ``index_put_``, so a
  dropped write touches no physical page. ``step_write`` takes only page
  ids in range — the serving step's, read from page-table rows — so it
  needs no data-dependent mask, whose ``nonzero`` would make the device
  report back to the host mid-step. Duplicate page ids only ever name the
  trash page (parked slots), where any winner is fine.
"""
from __future__ import annotations

from typing import Tuple

import torch

#: symmetric int8 grid: stored values live in [-127, 127]
INT8_MAX = 127.0
#: scale floor — an all-zero page quantizes/dequantizes exactly
SCALE_FLOOR = 1e-8


def resolve_kv_quant(mode: str, paged: bool) -> str:
    """``auto`` = on for the paged layout, off otherwise; ``on`` needs
    paging."""
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"kv_quant must be auto|on|off, got {mode!r}")
    if mode == "on" and not paged:
        raise ValueError(
            "kv_quant=on needs the paged cache layout (the page is the "
            "quantization/scale unit); set paged=true or kv_quant=auto/off")
    return "on" if paged and mode != "off" else "off"


def page_bytes(page_size: int, kv_heads: int, d_head: int,
               itemsize: int) -> int:
    """Bytes one layer of one unquantized page costs (K + V)."""
    return 2 * page_size * kv_heads * d_head * int(itemsize)


def quant_page_bytes(page_size: int, kv_heads: int, d_head: int) -> int:
    """Bytes one layer of one int8 page costs: K + V payload at one byte per
    cell, plus the two f32 scale rows ([kv_heads] each)."""
    return 2 * page_size * kv_heads * d_head + 2 * kv_heads * 4


def _requant(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Snap ``values`` onto the int8 grid of ``scales`` (broadcast-ready)."""
    q = torch.round(values / scales)
    return torch.clamp(q, -INT8_MAX, INT8_MAX).to(torch.int8)


def step_write(pages_i8: torch.Tensor, scales: torch.Tensor,
               page_ids: torch.Tensor, offsets: torch.Tensor,
               values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize-on-write for the decode step, one position per slot, in
    place. ``pages_i8`` [P, ps, Hkv, Dh] int8 and ``scales`` [P, Hkv] f32
    are one layer; ``page_ids``/``offsets`` [S]; ``values`` [S, Hkv, Dh].
    Each touched page is dequantized, the position inserted, the running-
    max scale updated and the whole page requantized. Every page id must
    lie in ``[0, P)``: the JAX function's dropped writes are the caller's
    to leave out."""
    page_ids = page_ids.long()
    offsets = offsets.long()
    slot = torch.arange(page_ids.shape[0], device=page_ids.device)
    cur_q = pages_i8[page_ids]                          # [S, ps, Hkv, Dh]
    cur_s = scales[page_ids]                            # [S, Hkv]
    vals = values.to(torch.float32)
    deq = cur_q.to(torch.float32) * cur_s[:, None, :, None]
    deq[slot, offsets] = vals
    # offset-0 writes begin a page's ownership life: rebase the running
    # max so a recycled page cannot inherit its previous owner's scale
    base_s = torch.where((offsets == 0)[:, None], 0.0, cur_s)
    new_s = torch.maximum(base_s, torch.clamp_min(
        torch.amax(vals.abs(), dim=-1) / INT8_MAX, SCALE_FLOOR))
    pages_i8[page_ids] = _requant(deq, new_s[:, None, :, None])
    scales[page_ids] = new_s
    return pages_i8, scales


def row_merge(pages_i8: torch.Tensor, scales: torch.Tensor,
              rows: torch.Tensor, values: torch.Tensor,
              logical_pos: torch.Tensor, valid: torch.Tensor,
              dtype: torch.dtype
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize-on-write for a window of positions through page-table rows
    (whole-prompt prefill), in place. ``rows`` [B, mp] physical page ids;
    ``values`` [B, W, Hkv, Dh]; ``logical_pos`` [B, W]; ``valid`` [B, W]
    masks cells that must not write. Returns ``(pages_i8, scales, ctx)``
    with ``ctx`` [B, mp * ps, Hkv, Dh] the post-write dequantized logical
    context in ``dtype``. Only pages a valid write landed on are written
    back; every other page (shared, other slots', the trash) is untouched."""
    num_physical, ps, hkv, dh = pages_i8.shape
    num_rows, mp = rows.shape
    rows = rows.long()
    logical_pos = logical_pos.long()
    row_q = pages_i8[rows.clamp(0, num_physical - 1)]   # [B, mp, ps, Hkv, Dh]
    row_s = scales[rows.clamp(0, num_physical - 1)]     # [B, mp, Hkv]
    deq = row_q.to(torch.float32) * row_s[:, :, None, :, None]
    flat = deq.reshape(num_rows, mp * ps, hkv, dh)
    vals = values.to(torch.float32)
    b_idx = torch.arange(num_rows, device=rows.device)[:, None].expand(
        logical_pos.shape)
    writes = valid & (logical_pos >= 0) & (logical_pos < mp * ps)
    write_b, write_pos = b_idx[writes], logical_pos[writes]
    flat[write_b, write_pos] = vals[writes]
    page_idx = write_pos // ps
    cell = write_b * mp + page_idx                      # flat (row, page)
    amax_upd = torch.zeros(num_rows * mp, hkv, dtype=torch.float32,
                           device=rows.device)
    amax_upd.scatter_reduce_(0, cell[:, None].expand(-1, hkv),
                             torch.amax(vals[writes].abs(), dim=-1),
                             reduce="amax", include_self=True)
    amax_upd = amax_upd.reshape(num_rows, mp, hkv)
    touched = torch.zeros(num_rows * mp, dtype=torch.bool, device=rows.device)
    touched[cell] = True
    touched = touched.reshape(num_rows, mp)
    # pages whose offset-0 cell this window writes begin (or fully rewrite)
    # an ownership life: rebase their running max at zero
    reset = torch.zeros(num_rows * mp, dtype=torch.bool, device=rows.device)
    reset[cell[write_pos % ps == 0]] = True
    reset = reset.reshape(num_rows, mp)
    base_s = torch.where(reset[..., None], 0.0, row_s)
    new_s = torch.maximum(base_s, torch.clamp_min(amax_upd / INT8_MAX,
                                                  SCALE_FLOOR))
    merged = flat.reshape(num_rows, mp, ps, hkv, dh)
    q_new = _requant(merged, new_s[:, :, None, :, None])
    write_rows = touched & (rows >= 0) & (rows < num_physical)
    pages_i8[rows[write_rows]] = q_new[write_rows]
    scales[rows[write_rows]] = new_s[write_rows]
    requant = q_new.to(torch.float32) * new_s[:, :, None, :, None]
    ctx_pages = torch.where(touched[:, :, None, None, None], requant, deq)
    ctx = ctx_pages.reshape(num_rows, mp * ps, hkv, dh).to(dtype)
    return pages_i8, scales, ctx


# -- tier transitions ---------------------------------------------------------

def extract_pages(pages_i8: torch.Tensor, scales: torch.Tensor,
                  page_ids: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather whole pages AND their scale rows for demotion to the host
    tier: ``pages_i8`` [L, P, ps, Hkv, Dh] int8 + ``scales`` [L, P, Hkv] f32
    over ``page_ids`` [n] -> ([L, n, ps, Hkv, Dh], [L, n, Hkv]), fresh
    tensors. The scales travel with the payload: a promotion restores
    both, so a host-tier hit dequantizes byte for byte what the writer
    stored. JAX pads ``page_ids`` to a fixed width so that one executable
    serves every batch; here ``n`` is the real page count."""
    page_ids = page_ids.long()
    return (pages_i8.index_select(1, page_ids),
            scales.index_select(1, page_ids))


def inject_pages(pages_i8: torch.Tensor, scales: torch.Tensor,
                 page_ids: torch.Tensor, payload: torch.Tensor,
                 payload_scales: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter promoted page payloads + scale rows back into the cache, IN
    PLACE: the inverse of :func:`extract_pages`. Every id must name a
    physical page (JAX's out-of-range pad lanes, which it drops, do not
    exist here)."""
    page_ids = page_ids.long()
    pages_i8.index_copy_(1, page_ids, payload)
    scales.index_copy_(1, page_ids, payload_scales)
    return pages_i8, scales


def dequant_gather(pages_i8: torch.Tensor, scales: torch.Tensor,
                   page_table: torch.Tensor, dtype: torch.dtype
                   ) -> torch.Tensor:
    """Gather each slot's page run into logical order and dequantize:
    [S, mp] table over [P, ps, Hkv, Dh] int8 pages + [P, Hkv] scales ->
    [S, mp * ps, Hkv, Dh] in ``dtype``."""
    page_table = page_table.long()
    gathered = pages_i8[page_table]                     # [S, mp, ps, Hkv, Dh]
    gathered_s = scales[page_table]                     # [S, mp, Hkv]
    deq = gathered.to(torch.float32) * gathered_s[:, :, None, :, None]
    num_slots, mp = page_table.shape
    return deq.reshape(num_slots, mp * pages_i8.shape[1],
                       *pages_i8.shape[2:]).to(dtype)
