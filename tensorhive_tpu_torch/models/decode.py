"""Autoregressive decoding with a KV cache — the PyTorch counterpart of
``tensorhive_tpu/models/decode.py``.

The JAX module runs prefill + generation as one jitted scan over donated
buffers. PyTorch runs eagerly, so here the cache is preallocated once and
written IN PLACE (the donation's purpose, without the copy), and the
decode loop is a Python loop of ``apply_step`` calls. The math is the JAX
module's: the same bucketed batched prefill (flash attention over the
prompt), the same masked grouped decode attention, the same greedy
argmax (first index among ties). Sampling draws Gumbel noise from a
``torch.Generator``, so sampled tokens agree with JAX in distribution, not
draw by draw.

``evaluate`` scores held-out next-token loss and perplexity over an
iterator of [B, L+1] batches (``data.prefetch_to_device``).
"""
from __future__ import annotations

import math
from typing import (
    Any,
    Dict,
    Iterator,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import torch

from ..device import DeviceLike, resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import decode_attention as _decode_attend
from .transformer import (
    Params,
    TransformerConfig,
    TransformerLM,
    _lm_head,
    _rmsnorm,
)

class KVCache(NamedTuple):
    k: torch.Tensor          # [layers, B, max_len, Hkv, Dh] (or paged)
    v: torch.Tensor


class QuantKVCache(NamedTuple):
    """Int8 paged KV cache: [layers, pages, page_size, Hkv, Dh] int8 payload
    plus [layers, pages, Hkv] f32 scales, indexed by the same physical page
    ids the page tables resolve."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor


def init_cache(config: TransformerConfig, batch: int,
               max_len: Optional[int] = None,
               device: DeviceLike = None) -> KVCache:
    """Contiguous cache [layers, B, max_len, Hkv, Dh] in ``config.dtype``."""
    device = resolve_device(device)
    max_len = max_len or config.max_seq_len
    shape = (config.n_layers, batch, max_len, config.kv_heads, config.d_head)
    return KVCache(k=torch.zeros(shape, dtype=config.dtype, device=device),
                   v=torch.zeros(shape, dtype=config.dtype, device=device))


def apply_step(params: Params, token: torch.Tensor, cache: KVCache,
               position: int, config: TransformerConfig
               ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step: logits for the NEXT position; the token's K/V are
    written into ``cache`` in place at ``position``."""
    x = params["tok_embed"][token.long()][:, None, :]          # [B, 1, D]
    positions = torch.full((token.shape[0], 1), position, dtype=torch.int32,
                           device=token.device)

    def attend(q, k, v, layer):
        cache.k[layer, :, position] = k[:, 0].to(cache.k.dtype)
        cache.v[layer, :, position] = v[:, 0].to(cache.v.dtype)
        return _decode_attend(q, cache.k[layer], cache.v[layer], position)

    for layer_index, block in enumerate(params["blocks"]):
        x = TransformerLM.block_forward(x, block, config, positions, attend,
                                        layer_index=layer_index)
    x = _rmsnorm(x, params["final_norm"]["scale"])
    return _lm_head(x[:, 0], params["w_lm_head"], config.dtype), cache


def _prefill_body(params: Params, prompt_head: torch.Tensor, cache: KVCache,
                  config: TransformerConfig,
                  real_len: Optional[int] = None) -> KVCache:
    """Write K/V for prompt positions 0..real_len-1 into the cache in ONE
    batched trunk pass (flash attention over the prompt, no LM head).
    ``prompt_head`` may be right-padded to a bucket; padded positions write
    zeros, and causal attention keeps every real position exact."""
    batch, width = prompt_head.shape
    x = params["tok_embed"][prompt_head.long()]
    positions = torch.arange(width, dtype=torch.int32,
                             device=prompt_head.device).expand(batch, width)
    valid = None
    if real_len is not None:
        valid = (torch.arange(width, device=prompt_head.device)
                 < real_len)[None, :, None, None]

    def attend(q, k, v, layer):
        write_k, write_v = k, v
        if valid is not None:
            write_k = torch.where(valid, k, 0)
            write_v = torch.where(valid, v, 0)
        cache.k[layer, :, :width] = write_k.to(cache.k.dtype)
        cache.v[layer, :, :width] = write_v.to(cache.v.dtype)
        return flash_attention(q, k, v, causal=True)

    for layer_index, block in enumerate(params["blocks"]):
        x = TransformerLM.block_forward(x, block, config, positions, attend,
                                        layer_index=layer_index)
    return cache


#: floor for prefill shape buckets
PREFILL_BUCKET_FLOOR = 16


def _prefill_bucket(length: int, cap: int,
                    floor: int = PREFILL_BUCKET_FLOOR) -> int:
    """Pad a prefill width up to the next power of two (min ``floor``),
    capped at ``cap`` (the widest head max_seq_len admits)."""
    bucket = max(floor, 1 << max(0, length - 1).bit_length())
    return min(bucket, max(length, cap))


def _sample(logits: torch.Tensor, temperature: float,
            top_k: Optional[int], generator: torch.Generator) -> torch.Tensor:
    """Categorical draw from ``softmax(logits / temperature)`` (top-k
    filtered: scores below the k-th value are excluded) by Gumbel-max."""
    scaled = logits / temperature
    if top_k is not None:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    return torch.argmax(scaled + _gumbel(scaled.shape, generator,
                                         logits.device), dim=-1)


def _gumbel(shape, generator: torch.Generator,
            device: torch.device) -> torch.Tensor:
    uniform = torch.rand(shape, generator=generator, device=device,
                         dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform.clamp_min(tiny)))


def generate(params: Params, config: TransformerConfig,
             prompt: Union[torch.Tensor, Sequence[Sequence[int]]],
             max_new_tokens: int, temperature: float = 0.0,
             top_k: Optional[int] = None, seed: int = 0,
             device: DeviceLike = None) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations: returns [B, P+N] int32.

    The prompt head (all but its last token) is prefilled in one batched
    pass at a power-of-two bucket width; each generated position is one
    ``apply_step``. ``temperature`` 0 is greedy."""
    device = resolve_device(device)
    if not config.causal:
        raise ValueError("generate() needs an autoregressive model; this "
                         "config is a bidirectional encoder (causal=False)")
    prompt = torch.as_tensor(prompt, dtype=torch.int32, device=device)
    batch, prompt_len = prompt.shape
    total = prompt_len + max_new_tokens
    if total > config.max_seq_len:
        raise ValueError(
            f"prompt+new = {total} exceeds max_seq_len {config.max_seq_len}")
    if top_k is not None and not 0 < top_k <= config.vocab_size:
        raise ValueError(
            f"top_k must be in (0, {config.vocab_size}], got {top_k}")
    sampling = temperature > 0.0
    prefilling = prompt_len > 1
    head_width = prompt_len - 1
    if prefilling:
        head_width = _prefill_bucket(
            prompt_len - 1, config.max_seq_len - max_new_tokens - 1)
    buffer_total = head_width + 1 + max_new_tokens if prefilling else total
    cache = init_cache(config, batch, max_len=buffer_total, device=device)
    tokens = torch.zeros((batch, buffer_total), dtype=torch.int32,
                         device=device)
    tokens[:, :prompt_len] = prompt
    start = 0
    if prefilling:
        head = torch.zeros((batch, head_width), dtype=torch.int32,
                           device=device)
        head[:, :prompt_len - 1] = prompt[:, :prompt_len - 1]
        _prefill_body(params, head, cache, config, real_len=prompt_len - 1)
        start = prompt_len - 1
    generator = torch.Generator(device=device).manual_seed(seed)
    for position in range(start, total - 1):
        logits, cache = apply_step(params, tokens[:, position], cache,
                                   position, config)
        if sampling:
            chosen = _sample(logits, temperature, top_k, generator)
        else:
            chosen = torch.argmax(logits, dim=-1)
        tokens[:, position + 1] = chosen.to(torch.int32)
    return tokens[:, :total]


@torch.no_grad()
def evaluate(params: Params, config: TransformerConfig,
             batches: Iterator[torch.Tensor], num_batches: int,
             mesh: Any = None) -> Dict[str, float]:
    """Mean held-out loss and perplexity over ``num_batches`` [B, L+1]
    token batches from ``batches`` — the JAX ``decode.evaluate``. The
    losses add up on the device and are read once after the loop (a read
    per batch would wait for the device every batch). An exhausted iterator
    raises."""
    if not config.causal:
        # next-token CE through bidirectional attention would see each
        # target in its own input: perplexity collapses toward 1
        raise ValueError("evaluate() scores next-token perplexity, which "
                         "needs an autoregressive model; this config is a "
                         "bidirectional encoder (causal=False)")
    if num_batches < 1:
        raise ValueError(f"num_batches must be >= 1, got {num_batches}")
    total = None
    for index in range(num_batches):
        try:
            tokens = next(batches)
        except StopIteration:
            raise ValueError(
                f"batches iterator exhausted at batch {index} of "
                f"{num_batches}") from None
        loss = TransformerLM.loss(params, tokens, config, mesh=mesh)
        total = loss if total is None else total + loss
    mean = float(total) / num_batches
    try:
        perplexity = math.exp(mean)
    except OverflowError:           # a diverged model
        perplexity = float("inf")
    return {"loss": mean, "perplexity": perplexity, "batches": num_batches}
