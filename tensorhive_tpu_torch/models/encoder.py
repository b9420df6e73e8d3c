"""Bidirectional encoder family: masked-language-model training — the
PyTorch counterpart of ``tensorhive_tpu/models/encoder.py``.

The encoder is the decoder-only model of ``models/transformer`` with
``causal=False``: every layer is shared, and the flash kernels take the
flag. What this module adds is the MLM objective (BERT-style dynamic
masking) and its adapter into ``train.make_train_step`` (the [B, 3, L]
packed batch).

Masks come from a ``torch.Generator``: they follow the JAX recipe in
distribution (``mask_ratio`` selected, of those 80% [MASK], 10% a random
token, 10% kept), not draw for draw. Tests that compare the losses hand
both sides the same (inputs, targets, mask).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .transformer import (
    PRESETS,
    Params,
    TransformerConfig,
    TransformerLM,
    _chunked_ce,
    _loss_chunk,
    _lse_minus_target,
)

#: encoder presets mirror the LM geometries with bidirectional attention;
#: the top vocab id is reserved as the [MASK] token (``mask_token_id``)
ENCODER_PRESETS: Dict[str, TransformerConfig] = {
    name: dataclasses.replace(PRESETS[name], causal=False)
    for name in ("tiny", "t2t-base", "t2t-big")
}


def mask_token_id(config: TransformerConfig) -> int:
    """[MASK] is the top vocab id: its embedding row already exists, and
    data pipelines must not emit it as text."""
    return config.vocab_size - 1


def mask_tokens(generator: torch.Generator, tokens: torch.Tensor,
                config: TransformerConfig, mask_ratio: float = 0.15
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BERT-style dynamic masking of [B, L] int ``tokens`` with draws from
    ``generator`` (on the tokens' device): each position is selected with
    probability ``mask_ratio``; a selected position becomes [MASK] with
    probability 0.8, a uniform random token with 0.1, and stays as it was
    with 0.1. Returns (inputs, targets, mask): targets are the tokens,
    mask [B, L] bool marks the selected positions."""
    shape, device = tokens.shape, tokens.device
    select = torch.rand(shape, generator=generator, device=device)
    op = torch.rand(shape, generator=generator, device=device)
    random_tokens = torch.randint(0, config.vocab_size, shape,
                                  generator=generator, device=device,
                                  dtype=tokens.dtype)
    mask = select < mask_ratio
    inputs = torch.where(mask & (op < 0.8),
                         torch.full_like(tokens, mask_token_id(config)),
                         tokens)
    inputs = torch.where(mask & (op >= 0.8) & (op < 0.9), random_tokens,
                         inputs)
    return inputs, tokens, mask


def mlm_loss(params: Params, inputs: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor, config: TransformerConfig,
             mesh: Any = None) -> torch.Tensor:
    """Cross entropy over the selected positions only, mean per selected
    token (f32). ``inputs``/``targets`` [B, L] int, ``mask`` [B, L] bool.
    Chunks the head and loss past the LM loss's threshold
    (``_loss_chunk``), with the mask as the per-token weight."""
    if mesh is not None:
        raise ValueError("mlm_loss: mesh is not yet ported")
    n_tokens = targets.shape[0] * targets.shape[1]
    count = torch.clamp(mask.sum(), min=1)
    chunk = _loss_chunk(n_tokens, config, targets.device)
    if chunk:
        x = TransformerLM.apply_trunk(params, inputs, config)
        total = _chunked_ce(x.reshape(n_tokens, -1),
                            targets.reshape(n_tokens), params["w_lm_head"],
                            config.dtype, chunk,
                            weights_flat=mask.reshape(n_tokens))
        return total / count
    logits = TransformerLM.apply(params, inputs, config)
    per_token = _lse_minus_target(logits, targets) * mask.to(torch.float32)
    return per_token.sum() / count


def pack_mlm_batch(generator: torch.Generator, tokens: torch.Tensor,
                   config: TransformerConfig,
                   mask_ratio: float = 0.15) -> torch.Tensor:
    """(inputs, targets, mask) of ``mask_tokens`` stacked into one
    [B, 3, L] tensor in the tokens' dtype, the batch ``mlm_loss_packed``
    takes through ``train.make_train_step``."""
    inputs, targets, mask = mask_tokens(generator, tokens, config,
                                        mask_ratio)
    return torch.stack([inputs, targets, mask.to(inputs.dtype)], dim=1)


def mlm_loss_packed(params: Params, packed: torch.Tensor,
                    config: TransformerConfig,
                    mesh: Any = None) -> torch.Tensor:
    """``loss_fn`` for ``train.make_train_step``: unpack [B, 3, L] and
    compute the masked cross entropy."""
    inputs, targets, mask = packed[:, 0], packed[:, 1], packed[:, 2]
    return mlm_loss(params, inputs, targets, mask.to(torch.bool), config,
                    mesh=mesh)


@torch.no_grad()
def mlm_evaluate(params: Params, config: TransformerConfig,
                 batches: Iterator[torch.Tensor], num_batches: int,
                 mesh: Any = None, *, seed: int = 0,
                 mask_ratio: float = 0.15) -> Dict[str, float]:
    """Held-out MLM evaluation, the encoder twin of ``decode.evaluate``:
    masks ``num_batches`` [B, L] batches with draws from one generator
    seeded ``seed`` (on the first batch's device, so a seed and a batch
    sequence give the same masks every time) and averages the masked
    cross entropy. Returns {'loss', 'pseudo_perplexity', 'batches'};
    pseudo-perplexity is exp(masked CE). An exhausted iterator raises."""
    if config.causal:
        raise ValueError("mlm_evaluate needs an encoder config "
                         "(causal=False); score causal LMs with "
                         "decode.evaluate")
    if num_batches < 1:
        raise ValueError(f"num_batches must be >= 1, got {num_batches}")
    generator = None
    total = None
    for index in range(num_batches):
        try:
            tokens = next(batches)
        except StopIteration:
            raise ValueError(
                f"batches iterator exhausted at batch {index} of "
                f"{num_batches}") from None
        if generator is None:
            generator = torch.Generator(device=tokens.device).manual_seed(seed)
        packed = pack_mlm_batch(generator, tokens, config, mask_ratio)
        loss = mlm_loss_packed(params, packed, config, mesh=mesh)
        total = loss if total is None else total + loss
    mean = float(total) / num_batches          # the one device read
    try:
        pseudo_perplexity = math.exp(mean)
    except OverflowError:                      # a diverged model
        pseudo_perplexity = float("inf")
    return {"loss": mean, "pseudo_perplexity": pseudo_perplexity,
            "batches": num_batches}


def init_encoder(config: Optional[TransformerConfig] = None,
                 preset: str = "t2t-base",
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None,
                 param_dtype: Optional[torch.dtype] = None
                 ) -> Tuple[Params, TransformerConfig]:
    """(params, config) for an encoder preset (or ``config``), params from
    ``TransformerLM.init``."""
    if config is None:
        config = ENCODER_PRESETS[preset]
    if config.causal:
        raise ValueError("encoder config must have causal=False")
    device = resolve_device(device)
    return (TransformerLM.init(config, generator, device,
                               param_dtype=param_dtype), config)
