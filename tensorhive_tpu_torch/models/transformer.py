"""Decoder-only transformer LM — the PyTorch counterpart of
``tensorhive_tpu/models/transformer.py`` (inference half).

Same architecture and the same parameter tree as the JAX model, so weights
made by ``TransformerLM.init`` on either side describe the same function:

* pre-RMSNorm (eps 1e-6, computed in f32), interleaved RoPE, SwiGLU MLP;
* weights in the JAX ``[in, out]`` layout, applied as ``x @ w`` (no
  ``nn.Linear``, which would store every weight transposed);
* params are a plain dict mirroring the JAX pytree: ``tok_embed``,
  ``final_norm.scale``, ``w_lm_head`` and ``blocks[i]`` with
  ``attn_norm``/``mlp_norm``/``wq``/``wk``/``wv``/``wo``/``w_in``/
  ``w_gate``/``w_out``.

Weights are cast to ``config.dtype`` at use, as the JAX model's
``.astype(dtype)`` does: serving weights already are in ``config.dtype``
(``init`` and ``convert.params_from_jax`` make them so by default, and a
bf16 model reads half the weight bytes), so the cast is a no-op there;
training keeps f32 masters (``param_dtype=torch.float32``) and gets f32
gradients through the cast. Norm scales stay f32, as ``_rmsnorm`` uses
them.

Training: ``loss`` (full or chunked cross entropy; ``_chunked_ce`` takes
per-token weights, which the MLM loss of ``models/encoder`` passes), the
``remat`` policies
("block" checkpoints whole blocks, "mlp" only the MLP half) through
``torch.utils.checkpoint``, and ``train_flops_per_token``. The mesh and
pipeline paths are not ported yet.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..ops.flash_attention import flash_attention

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 1408
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16   # activation/matmul dtype
    rope_theta: float = 10_000.0
    #: recompute activations in the backward (training only)
    remat: bool = True
    #: what ``remat`` recomputes: "block" checkpoints whole blocks (the
    #: backward re-runs everything, the flash forward included); "mlp"
    #: checkpoints only the MLP half, so q/k/v and the flash O/LSE stay
    #: saved and the backward never re-runs the flash forward
    remat_policy: str = "block"
    #: token-chunk size of the memory-lean CE loss (0 disables); engaged
    #: only when the full logits would pass ``_chunk_threshold_bytes``
    loss_chunk_tokens: int = 16_384
    #: grouped-query attention: number of K/V heads (None = n_heads)
    n_kv_heads: Optional[int] = None
    causal: bool = True
    #: b·h rows per program of the head-blocked flash forward (the JAX
    #: ``TPUHIVE_FLASH_BH_BLOCK``; 1 = off, the JAX default). Clamped by
    #: ``ops.flash_attention.fwd_bh_block``, so GQA configs stay at 1
    flash_bh_block: int = 1

    @property
    def d_head(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be a multiple of n_heads")
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_kv_heads or self.n_heads
        if self.n_heads % kv:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        return kv


#: the JAX package's presets, at the same widths
PRESETS: Dict[str, TransformerConfig] = {
    "tiny": TransformerConfig(vocab_size=512, d_model=64, n_heads=4, n_layers=2,
                              d_ff=176, max_seq_len=256),
    "t2t-base": TransformerConfig(vocab_size=32_000, d_model=512, n_heads=8,
                                  n_layers=6, d_ff=2048, max_seq_len=2048),
    "t2t-big": TransformerConfig(vocab_size=32_000, d_model=1024, n_heads=16,
                                 n_layers=6, d_ff=4096, max_seq_len=2048),
    "1b": TransformerConfig(vocab_size=32_000, d_model=2048, n_heads=16,
                            n_layers=16, d_ff=5632, max_seq_len=4096),
    # Llama-7B-class dims, GQA-8: ~5.9 B parameters, ~12 GB in bf16 — one
    # H100 holds it whole, with room for the paged KV pool
    "7b": TransformerConfig(vocab_size=32_000, d_model=4096, n_heads=32,
                            n_layers=32, d_ff=11_008, max_seq_len=4096,
                            n_kv_heads=8, remat_policy="mlp"),
}

#: chunk the CE loss past this many logits bytes where the device cannot
#: report its memory (the CPU)
CHUNKED_LOSS_THRESHOLD_BYTES = 2 << 30
REMAT_POLICIES = ("block", "mlp")


@functools.lru_cache(maxsize=None)
def _chunk_threshold_bytes(device: torch.device) -> int:
    """Logits bytes past which the loss chunks: 0.7 of the card's memory
    (``torch.cuda.mem_get_info``), 2 GiB on the CPU — the JAX rule, which
    keeps the full-logits path wherever it still fits."""
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        return int(total * 0.7)
    return CHUNKED_LOSS_THRESHOLD_BYTES


def _loss_chunk(n_tokens: int, config: "TransformerConfig",
                device: torch.device) -> int:
    """Token-chunk size of the chunked CE path, or 0 for the full-logits
    path. The chunk shrinks to a divisor of ``n_tokens`` (gcd) so awkward
    batches still chunk."""
    if not config.loss_chunk_tokens:
        return 0
    if n_tokens * config.vocab_size * 4 <= _chunk_threshold_bytes(device):
        return 0
    return math.gcd(n_tokens, config.loss_chunk_tokens)


def _lse_minus_target(logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy as logsumexp - target logit [..., L],
    without a log-probability tensor."""
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return lse - target_logit


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim of [B, L, H, D], INTERLEAVED: the
    pairs are ``(x[..., 0::2], x[..., 1::2])`` and the rotated halves are
    re-interleaved — not the half-split layout of common Llama ports."""
    d = x.shape[-1]
    exponent = -torch.arange(0, d, 2, dtype=torch.float32,
                             device=x.device) / d
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exponent)
    angles = positions[:, :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.reshape(x.shape).to(x.dtype)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    norm = x.to(torch.float32)
    norm = norm * torch.rsqrt(torch.mean(norm * norm, dim=-1, keepdim=True)
                              + 1e-6)
    return (norm * scale.to(torch.float32)).to(x.dtype)


def _lm_head(x: torch.Tensor, w_head: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Logits in f32 from operands rounded to ``dtype`` (``config.dtype``):
    the JAX head's ``jnp.dot(x.astype(dtype), w.astype(dtype),
    preferred_element_type=f32)``. Widening both rounded operands to f32 is
    exact, so this is the same product with f32 accumulation and an f32
    result (a bf16 matmul would round the logits to bf16). An f32 master
    head is rounded to ``dtype`` first."""
    return (x.to(dtype).to(torch.float32)
            @ w_head.to(dtype).to(torch.float32))


def _chunked_ce(x_flat: torch.Tensor, targets_flat: torch.Tensor,
                w_head: torch.Tensor, dtype: torch.dtype,
                chunk_tokens: int,
                weights_flat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of weight * (logsumexp - target logit) over all tokens, one
    token chunk at a time (``weights_flat`` None = unweighted; the MLM loss
    passes its mask). Each chunk runs under ``torch.utils.checkpoint``, so
    the backward recomputes its logits instead of keeping them: peak memory
    is one [chunk, vocab] f32 buffer either way."""
    if weights_flat is None:
        weights_flat = torch.ones(x_flat.shape[0], dtype=torch.float32,
                                  device=x_flat.device)
    weights_flat = weights_flat.to(torch.float32)

    def one_chunk(x_blk, t_blk, w_blk):
        logits = _lm_head(x_blk, w_head, dtype)
        return torch.sum(_lse_minus_target(logits, t_blk) * w_blk)

    sums = [checkpoint(one_chunk, x_blk, t_blk, w_blk, use_reentrant=False)
            for x_blk, t_blk, w_blk in zip(x_flat.split(chunk_tokens),
                                           targets_flat.split(chunk_tokens),
                                           weights_flat.split(chunk_tokens))]
    return torch.stack(sums).sum()


Attend = Callable[..., torch.Tensor]


class TransformerLM(nn.Module):
    """The model as a module over a plain param dict, plus the JAX
    package's ``init`` / ``apply`` / block functions as static methods.

    ``TransformerLM(config, device=None)`` makes random params with
    ``init`` on the device (``None`` = ``cuda``); ``forward`` is
    ``apply``."""

    def __init__(self, config: TransformerConfig,
                 params: Optional[Params] = None, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None) -> None:
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        self.params = (params if params is not None else
                       TransformerLM.init(config, generator, self.device))

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        return TransformerLM.apply(self.params, tokens, self.config,
                                   positions=positions)

    # -- init ---------------------------------------------------------------
    @staticmethod
    def init(config: TransformerConfig,
             generator: Optional[torch.Generator] = None,
             device: DeviceLike = None,
             param_dtype: Optional[torch.dtype] = None) -> Params:
        """Random params with the JAX init's distributions
        (``transformer.py:229-257``): embedding N(0, 0.02²), dense weights
        N(0, 1/fan_in), norm scales 1. The draws come from ``generator``
        (default: seed 0 on the device), so they are NOT the JAX draws —
        parity tests carry JAX-made weights across with ``convert``.
        Matmul weights and the embedding are stored in ``param_dtype``
        (default ``config.dtype``; training passes f32 masters)."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        dtype = config.dtype if param_dtype is None else param_dtype

        def normal(std: float, *shape: int) -> torch.Tensor:
            values = torch.randn(shape, generator=generator, device=device,
                                 dtype=torch.float32)
            return (values * std).to(dtype)

        def dense(fan_in: int, *shape: int) -> torch.Tensor:
            return normal(1.0 / math.sqrt(fan_in), *shape)

        def ones(size: int) -> Dict[str, torch.Tensor]:
            return {"scale": torch.ones(size, dtype=torch.float32,
                                        device=device)}

        d, h, dh, f = (config.d_model, config.n_heads, config.d_head,
                       config.d_ff)
        kv = config.kv_heads
        params: Params = {
            "tok_embed": normal(0.02, config.vocab_size, d),
            "final_norm": ones(d),
            "w_lm_head": dense(d, d, config.vocab_size),
            "blocks": [],
        }
        for _ in range(config.n_layers):
            params["blocks"].append({
                "attn_norm": ones(d),
                "mlp_norm": ones(d),
                "wq": dense(d, d, h * dh),
                "wk": dense(d, d, kv * dh),
                "wv": dense(d, d, kv * dh),
                "wo": dense(h * dh, h * dh, d),
                "w_in": dense(d, d, f),
                "w_gate": dense(d, d, f),
                "w_out": dense(f, f, d),
            })
        return params

    @staticmethod
    def param_count(params: Params) -> int:
        count = params["tok_embed"].numel() + params["w_lm_head"].numel()
        count += params["final_norm"]["scale"].numel()
        for block in params["blocks"]:
            for value in block.values():
                count += (value["scale"].numel() if isinstance(value, dict)
                          else value.numel())
        return count

    # -- forward ------------------------------------------------------------
    @staticmethod
    def block_attn_half(x, block, config: TransformerConfig, positions,
                        attend: Attend,
                        layer_index: Optional[int] = None) -> torch.Tensor:
        """Pre-norm QKV + rope + ``attend`` + output projection, residual
        added. ``attend(q, k, v)`` — or ``attend(q, k, v, layer_index)``
        when the caller passes ``layer_index`` (cache-writing strategies)."""
        dtype = config.dtype
        h = _rmsnorm(x, block["attn_norm"]["scale"])
        b, length, _ = h.shape
        q = (h @ block["wq"].to(dtype)).reshape(b, length, config.n_heads,
                                                config.d_head)
        k = (h @ block["wk"].to(dtype)).reshape(b, length, config.kv_heads,
                                                config.d_head)
        v = (h @ block["wv"].to(dtype)).reshape(b, length, config.kv_heads,
                                                config.d_head)
        q = _rope(q, positions, config.rope_theta)
        k = _rope(k, positions, config.rope_theta)
        attn = (attend(q, k, v) if layer_index is None
                else attend(q, k, v, layer_index))
        attn = attn.reshape(b, length, config.n_heads * config.d_head)
        return x + attn @ block["wo"].to(dtype)

    @staticmethod
    def block_mlp_half(x, block, config: TransformerConfig) -> torch.Tensor:
        """SwiGLU MLP half of a block, residual added."""
        dtype = config.dtype
        h = _rmsnorm(x, block["mlp_norm"]["scale"])
        gated = (F.silu(h @ block["w_gate"].to(dtype))
                 * (h @ block["w_in"].to(dtype)))
        return x + gated @ block["w_out"].to(dtype)

    @staticmethod
    def block_forward(x, block, config: TransformerConfig, positions,
                      attend: Attend,
                      layer_index: Optional[int] = None) -> torch.Tensor:
        """One block — the single copy of the block math that prefill,
        decode and ``apply`` share, each with its own ``attend``."""
        x = TransformerLM.block_attn_half(x, block, config, positions, attend,
                                          layer_index=layer_index)
        return TransformerLM.block_mlp_half(x, block, config)

    @staticmethod
    def apply_trunk(params: Params, tokens: torch.Tensor,
                    config: TransformerConfig,
                    positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Everything before the LM head: normed activations
        [B, L, d_model] in ``config.dtype``. Under autograd with
        ``config.remat`` the blocks are checkpointed by ``remat_policy``."""
        if config.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                             f"got {config.remat_policy!r}")
        if positions is None:
            positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=tokens.device
                                     ).expand(tokens.shape)
        x = params["tok_embed"].to(config.dtype)[tokens.long()]

        def attend(q, k, v):
            # GQA is native in the kernel (KV head h // group, no expanded
            # copy); the plain version on CPU tensors expands internally
            return flash_attention(q, k, v, causal=config.causal,
                                   bh_block=config.flash_bh_block)

        def plain_block(x, block):
            return TransformerLM.block_forward(x, block, config, positions,
                                               attend)

        def remat_block(x, block):
            return checkpoint(plain_block, x, block, use_reentrant=False)

        def remat_mlp(x, block):
            # the attention half's activations, the flash O/LSE residuals
            # included, stay saved: the backward re-runs only the MLP half
            x = TransformerLM.block_attn_half(x, block, config, positions,
                                              attend)
            return checkpoint(TransformerLM.block_mlp_half, x, block, config,
                              use_reentrant=False)

        block_fn = plain_block
        if config.remat and torch.is_grad_enabled():
            block_fn = (remat_mlp if config.remat_policy == "mlp"
                        else remat_block)
        for block in params["blocks"]:
            x = block_fn(x, block)
        return _rmsnorm(x, params["final_norm"]["scale"])

    @staticmethod
    def apply(params: Params, tokens: torch.Tensor,
              config: TransformerConfig,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [B, L, vocab] in f32."""
        x = TransformerLM.apply_trunk(params, tokens, config,
                                      positions=positions)
        return _lm_head(x, params["w_lm_head"], config.dtype)

    # -- loss ---------------------------------------------------------------
    @staticmethod
    def loss(params: Params, tokens: torch.Tensor, config: TransformerConfig,
             mesh: Any = None) -> torch.Tensor:
        """Next-token cross entropy, mean over tokens (f32). ``tokens`` is
        [B, L+1]: inputs and shifted targets."""
        if mesh is not None:
            raise ValueError("TransformerLM.loss: mesh is not yet ported")
        if not config.causal:
            # bidirectional attention lets position p see token p+1, its
            # own target: the next-token loss would train a copy-through
            raise ValueError(
                "TransformerLM.loss is the autoregressive objective; this "
                "config is a bidirectional encoder (causal=False)")
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        n_tokens = targets.shape[0] * targets.shape[1]
        chunk = _loss_chunk(n_tokens, config, tokens.device)
        if chunk:
            x = TransformerLM.apply_trunk(params, inputs, config)
            total = _chunked_ce(x.reshape(n_tokens, -1),
                                targets.reshape(n_tokens),
                                params["w_lm_head"], config.dtype, chunk)
            return total / n_tokens
        logits = TransformerLM.apply(params, inputs, config)
        return torch.mean(_lse_minus_target(logits, targets))


def train_flops_per_token(config: TransformerConfig, seq_len: int,
                          remat: bool = False) -> float:
    """Analytic model FLOPs per trained token (matmuls only), for MFU — the
    JAX formula: forward Q+O projections 4·D², K+V 4·D·Hkv·Dh, SwiGLU
    6·D·F, attention core 2·2·S·D halved by causality, LM head 2·D·V;
    training 3x forward, and remat re-runs each block's forward once more
    (not the head)."""
    d, f, v = config.d_model, config.d_ff, config.vocab_size
    kv_dim = config.kv_heads * config.d_head
    attn_core = (2 if config.causal else 4) * seq_len * d
    per_layer = 4 * d * d + 4 * d * kv_dim + 6 * d * f + attn_core
    fwd = config.n_layers * per_layer + 2 * d * v
    if remat:
        return 4.0 * config.n_layers * per_layer + 3.0 * 2 * d * v
    return 3.0 * fwd
