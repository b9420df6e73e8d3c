"""Serving configuration of the port: a copy of the ``GenerationConfig``
fields of ``tensorhive_tpu/config.py`` (``[generation_service]``) that the
ported engine reads, with the JAX package's defaults.

The prefix cache with chunked prefill (``prefix_cache``; ``auto`` = on
for the paged layout), the contiguous layout (``paged=False``), the
speculative lane (``speculative``; ``auto`` = on where the engine runs on
the card, off on the CPU), host KV tiering (``host_kv_bytes`` > 0, paged
int8 with the prefix cache) and per-request deadlines
(``default_deadline_s``, ``max_deadline_s``) are served. The serving mesh
(``mesh_dp``/``mesh_tp`` > 1) is accepted here and refused by
``build_engine`` with a "not yet ported" error.
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
    host_kv_bytes: int = 0           # host-RAM budget for demoted int8
                                     # pages; 0 = no tier
    speculative: str = "auto"        # draft-model speculative decoding:
                                     # auto = on where the engine runs on
                                     # the card, off on the CPU. Greedy
                                     # output is token-identical to the
                                     # non-speculative engine's either way
    draft_preset: str = ""           # draft model preset (must share the
                                     # vocab); "" = self-draft from the
                                     # target's first draft_layers layers
    draft_layers: int = 0            # self-draft depth (0 = half the
                                     # target's layers, min 1)
    spec_tokens: int = 4             # draft tokens proposed + verified in
                                     # one batched pass per tick
    queue_depth: int = 32
    max_new_tokens: int = 128        # per-request cap
    top_k: int = 0                   # 0 = no top-k sampling filter
    eos_token: int = -1              # -1 = no EOS, run to max_new_tokens
    max_concurrent_per_user: int = 4  # 0 = unlimited
    default_deadline_s: float = 120.0  # per-request wall budget (queue +
                                       # prefill + decode) when the caller
                                       # gives none; 0 = no deadline
    max_deadline_s: float = 600.0    # ceiling for per-request overrides
