"""Engine factory of the port — the counterpart of ``build_engine`` in
``tensorhive_tpu/core/services/generation.py`` (the ``GenerationService``
daemon, its supervisor and checkpoint loading are not ported yet)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from ...config import GenerationConfig
from ...device import DeviceLike, resolve_device
from ...models.transformer import PRESETS, Params, TransformerLM
from ...serving.engine import SlotEngine


def build_engine(generation: GenerationConfig, device: DeviceLike = None,
                 params: Optional[Params] = None) -> SlotEngine:
    """Construct the slot engine from the serving config and warm it, so
    the first request pays no first-use cost.

    ``params`` None makes random weights with ``TransformerLM.init`` on the
    device (seed 0); given params must already live on the device, in the
    preset's dtype. ``device`` None means ``cuda`` and raises without one."""
    device = resolve_device(device)
    if generation.preset not in PRESETS:
        raise ValueError(
            f"[generation_service] preset {generation.preset!r} unknown; "
            f"choose from {sorted(PRESETS)}")
    if generation.mesh_dp < 1 or generation.mesh_tp < 1:
        raise ValueError(
            f"[generation_service] mesh_dp/mesh_tp must be >= 1, got "
            f"{generation.mesh_dp}/{generation.mesh_tp}")
    for knob in ("mesh_dp", "mesh_tp"):
        if getattr(generation, knob) > 1:
            raise ValueError(f"{knob}={getattr(generation, knob)} is not yet "
                             "ported to tensorhive_tpu_torch")
    model_config = PRESETS[generation.preset]
    max_len = generation.max_len or model_config.max_seq_len
    model_config = dataclasses.replace(
        model_config, max_seq_len=max(max_len, model_config.max_seq_len))
    if params is None:
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
        speculative=generation.speculative,
        host_kv_bytes=generation.host_kv_bytes,
        queue_depth=generation.queue_depth,
        top_k=generation.top_k or None,
        eos_token=None if generation.eos_token < 0 else generation.eos_token,
        max_new_tokens_cap=generation.max_new_tokens,
        max_concurrent_per_user=generation.max_concurrent_per_user,
        device=device,
    )
    engine.warmup(prompt_lens=(16, max_len // 2))
    return engine
