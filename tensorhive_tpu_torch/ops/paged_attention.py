"""Paged-attention decode — the PyTorch + CUDA counterpart of
``tensorhive_tpu/ops/paged_attention.py``.

``paged_attention`` launches the hand-written kernel
``csrc/paged_decode.cu`` for CUDA tensors: one query token per slot
against that slot's KV pages, read through its page-table row, for
bf16/f32 pages and for int8 pages with per-(page, kv_head) f32 scales.
Each (slot, kv_head) is split over CTAs of 256 tokens (flash-decoding)
whose partial softmax states one of them merges; the wrapper allocates the
partials and owns the merge tickets. The launch grid depends only on the
shapes, never on ``positions``, so a call can be captured in a CUDA graph
and replayed after positions and page tables change. For CPU tensors it
runs its plain version, ``paged_attention_reference`` (the JAX package's
page gather: gather, dequantize, masked grouped softmax) — there is no
fallback for CUDA tensors.

The CUDA kernel takes d_head 16, 32, 64 or 128 and 1, 2, 4 or 8 query
heads per kv head, at any page size and page-table width; on the card the
wrapper raises for other shapes (the JAX package falls back to its gather).

``launches`` counts kernel launches per page type; the kernel-vs-plain
checks call ``paged_attention_reference`` directly and do not count.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import cuda_build
from . import kv_quant as kvq

NEG_INF = -1e30

#: kernel launches per page element type (the main-path counters)
launches: Dict[str, int] = {"bf16": 0, "f32": 0, "int8": 0}

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAGE_DTYPES = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16"),
                torch.int8: (2, "int8")}
_HEAD_DIMS = (16, 32, 64, 128)
_GROUPS = (1, 2, 4, 8)

#: merge tickets per device, [slots * kv_heads] int32: zero between calls
#: (the kernel's merging CTA resets its own); one call at a time a device
_tickets: Dict[int, torch.Tensor] = {}


def resolve_paged_kernel(mode: str) -> str:
    """Resolve the ``paged_kernel`` knob: ``on`` and ``auto`` -> ``"cuda"``,
    the kernel for bf16/f32 and int8 pages alike (CPU tensors run its plain
    version). The JAX package's ``auto`` keeps its XLA gather under int8 on
    the strength of a TPU measurement, which does not carry over to this
    card; ``off`` (that gather as an operator choice) would run the plain
    version on the card and is refused."""
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"paged_kernel must be auto|on|off, got {mode!r}")
    if mode == "off":
        raise ValueError(
            "paged_kernel='off' (the plain page gather) is not offered by "
            "tensorhive_tpu_torch: decode always runs the CUDA "
            "paged-attention kernel; use auto or on")
    return "cuda"


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, position) -> torch.Tensor:
    """Masked grouped decode attention over a contiguous cache — the JAX
    package's ``models/decode._decode_attend``. q [B, 1, H, Dh]; caches
    [B, S, Hkv, Dh]; attend to key positions <= ``position`` (an int, or a
    tensor broadcastable to [B,1,1,1,1]). GQA attends against the
    unexpanded cache (head i uses kv head i // group). Products accumulate
    in f32 from the cache's dtype; the probabilities are rounded to the
    cache dtype before the value product, as in the JAX function."""
    batch, _, heads, d_head = q.shape
    kv_heads = k_cache.shape[2]
    group = heads // kv_heads
    scale = d_head ** -0.5
    q_grouped = q.reshape(batch, 1, kv_heads, group, d_head)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q_grouped.to(torch.float32),
                          k_cache.to(torch.float32)) * scale
    key_positions = torch.arange(k_cache.shape[1], device=q.device)
    mask = key_positions <= position
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd",
                       probs.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(batch, 1, heads, d_head).to(q.dtype)


def paged_attention_reference(q, k_pages, v_pages, page_table, positions,
                              k_scales=None, v_scales=None) -> torch.Tensor:
    """The plain version, the JAX package's page-gather path: gather each
    slot's pages into logical order (dequantizing int8 pages to q's dtype),
    then :func:`decode_attention`. Entries past a slot's position (trash or
    unassigned pages) are masked to probability 0."""
    num_slots, max_pages = page_table.shape
    window = max_pages * k_pages.shape[1]
    if k_scales is not None:
        k = kvq.dequant_gather(k_pages, k_scales, page_table, q.dtype)
        v = kvq.dequant_gather(v_pages, v_scales, page_table, q.dtype)
    else:
        table = page_table.long()
        k = k_pages[table].reshape(num_slots, window, *k_pages.shape[2:])
        v = v_pages[table].reshape(num_slots, window, *v_pages.shape[2:])
    return decode_attention(q, k, v, positions[:, None, None, None, None])


def _library() -> ctypes.CDLL:
    library = cuda_build.load("paged_decode")
    function = library.thp_paged_decode
    if function.argtypes is None:
        function.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 11
                             + [ctypes.c_int] * 8
                             + [ctypes.c_float, ctypes.c_void_p])
        function.restype = ctypes.c_int
    return library


def _merge_tickets(device: torch.device, count: int) -> torch.Tensor:
    tickets = _tickets.get(device.index)
    if tickets is None or tickets.numel() < count:
        tickets = torch.zeros(max(count, 256), dtype=torch.int32,
                              device=device)
        _tickets[device.index] = tickets
    return tickets


def _check_inputs(q, k_pages, v_pages, page_table, positions, k_scales,
                  v_scales) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [S, 1, H, Dh], got {tuple(q.shape)}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("k_pages/v_pages must be [P, page_size, Hkv, Dh] "
                         "of one shape")
    slots, _, heads, d_head = q.shape
    kv_heads = k_pages.shape[2]
    if k_pages.shape[3] != d_head or heads % kv_heads:
        raise ValueError("pages must share q's d_head and divide its heads")
    if d_head not in _HEAD_DIMS or heads // kv_heads not in _GROUPS:
        raise ValueError(f"the CUDA kernel takes d_head in {_HEAD_DIMS} and "
                         f"{_GROUPS} query heads per kv head")
    if page_table.dim() != 2 or page_table.shape[0] != slots:
        raise ValueError("page_table must be [S, max_pages]")
    if positions.shape != (slots,):
        raise ValueError("positions must be [S]")
    if page_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("page_table and positions must be int32")
    if q.dtype not in _Q_DTYPES:
        raise ValueError(f"q must be bf16 or f32, got {q.dtype}")
    if k_pages.dtype not in _PAGE_DTYPES or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"pages must be bf16, f32 or int8, got "
                         f"{k_pages.dtype}/{v_pages.dtype}")
    quant = k_pages.dtype == torch.int8
    if quant:
        for scales in (k_scales, v_scales):
            if (scales is None or scales.dtype != torch.float32
                    or scales.shape != (k_pages.shape[0], kv_heads)):
                raise ValueError("int8 pages need f32 k_scales/v_scales "
                                 "[P, Hkv]")
    elif k_pages.dtype != q.dtype or k_scales is not None:
        raise ValueError("bf16/f32 pages must match q's dtype and take no "
                         "scales")
    tensors = [q, k_pages, v_pages, page_table, positions]
    if quant:
        tensors += [k_scales, v_scales]
    for tensor in tensors:
        if tensor.device != q.device:
            raise ValueError("every operand must be on q's device")
        if not tensor.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous operands")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16 or q.data_ptr() % 4:
        raise ValueError("the CUDA kernel takes 16-byte aligned pages and a "
                         "4-byte aligned q")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    positions: torch.Tensor,
                    k_scales: Optional[torch.Tensor] = None,
                    v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged decode attention. q [S, 1, H, Dh]; pages [P, page_size, Hkv,
    Dh] (bf16/f32 like q, or int8 with ``k_scales``/``v_scales`` [P, Hkv]
    f32); page_table [S, max_pages] int32; positions [S] int32 — slot s
    attends to logical positions <= positions[s]. Returns [S, 1, H, Dh] in
    q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         positions, k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check_inputs(q, k_pages, v_pages, page_table, positions, k_scales,
                  v_scales)
    slots, _, heads, d_head = q.shape
    num_pages, page_size, kv_heads, _ = k_pages.shape
    page_code, variant = _PAGE_DTYPES[k_pages.dtype]
    quant = k_pages.dtype == torch.int8
    library = _library()
    chunk = library.thp_paged_decode_chunk_tokens()
    max_pages = page_table.shape[1]
    chunks = -(-max_pages * page_size // chunk)
    out = torch.empty_like(q)
    part_acc = torch.empty(slots * heads * chunks * d_head,
                           dtype=torch.float32, device=q.device)
    part_ml = torch.empty(slots * heads * chunks * 2, dtype=torch.float32,
                          device=q.device)
    tickets = _merge_tickets(q.device, slots * kv_heads)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = library.thp_paged_decode(
        _Q_DTYPES[q.dtype], page_code, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), k_scales.data_ptr() if quant else None,
        v_scales.data_ptr() if quant else None, page_table.data_ptr(),
        positions.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), tickets.data_ptr(), slots, heads, kv_heads,
        d_head, num_pages, page_size, max_pages, chunks,
        float(d_head ** -0.5), stream)
    cuda_build.check(status, "paged_decode")
    launches[variant] += 1
    return out
