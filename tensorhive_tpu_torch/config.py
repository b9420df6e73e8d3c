"""Serving configuration of the port: a copy of the ``GenerationConfig``
fields of ``tensorhive_tpu/config.py`` (``[generation_service]``) that the
ported engine reads, with the JAX package's defaults.

The prefix cache with chunked prefill (``prefix_cache``; ``auto`` = on
for the paged layout) and the contiguous layout (``paged=False``) are
served. Values the port cannot serve yet are accepted here and refused by
``build_engine``/``SlotEngine`` with a "not yet ported" error: the
speculative lane (``speculative="on"``; ``auto`` resolves to off), host KV
tiering (``host_kv_bytes > 0``) and the serving mesh (``mesh_dp``/
``mesh_tp`` > 1).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class GenerationConfig:
    preset: str = "tiny"
    slots: int = 8                   # the decode batch size
    max_len: int = 0                 # 0 = the preset's max_seq_len
    mesh_dp: int = 1
    mesh_tp: int = 1
    paged: bool = True
    page_size: int = 16              # tokens per KV page
    kv_pages: int = 0                # 0 = slots * ceil(max_len / page_size)
                                     # bytes' worth of pages
    paged_kernel: str = "auto"       # auto|on = the CUDA paged-attention
                                     # kernel; off is refused
    kv_quant: str = "auto"           # int8 pages with per-(page, kv_head)
                                     # scales; auto = on for the paged layout
    prefix_cache: str = "auto"      # radix prefix cache + chunked prefill;
                                     # auto = on for the paged layout
    prefix_min_tokens: int = 32      # shortest prefix match worth sharing
    prefill_chunk_tokens: int = 256  # prefill positions per chunk (per
                                     # tick); 0 = one chunk per prompt
    host_kv_bytes: int = 0
    speculative: str = "auto"
    queue_depth: int = 32
    max_new_tokens: int = 128        # per-request cap
    top_k: int = 0                   # 0 = no top-k sampling filter
    eos_token: int = -1              # -1 = no EOS, run to max_new_tokens
    max_concurrent_per_user: int = 4  # 0 = unlimited
