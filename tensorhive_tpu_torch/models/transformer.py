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

Weights differ from the JAX package in one deliberate way: the JAX model
keeps f32 masters and casts each matmul weight with ``.astype(dtype)`` on
every use; the port casts the matmul weights and the embedding to
``config.dtype`` ONCE, when they are made or loaded (``init``,
``convert.params_from_jax``). The values are the same, and a bf16 model
reads half the weight bytes. Norm scales stay f32, as ``_rmsnorm`` uses
them.

Training (remat, loss, mesh and pipeline paths) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

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
    #: grouped-query attention: number of K/V heads (None = n_heads)
    n_kv_heads: Optional[int] = None
    causal: bool = True

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
                            n_kv_heads=8),
}


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


def _lm_head(x: torch.Tensor, w_head: torch.Tensor) -> torch.Tensor:
    """Logits in f32 from ``config.dtype`` operands: the JAX head's
    ``preferred_element_type=f32`` contract. Widening both operands to f32
    is exact, so this is the same product with f32 accumulation and an
    f32 result (a bf16 matmul would round the logits to bf16)."""
    return x.to(w_head.dtype).to(torch.float32) @ w_head.to(torch.float32)


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
             device: DeviceLike = None) -> Params:
        """Random params with the JAX init's distributions
        (``transformer.py:229-257``): embedding N(0, 0.02²), dense weights
        N(0, 1/fan_in), norm scales 1. The draws come from ``generator``
        (default: seed 0 on the device), so they are NOT the JAX draws —
        parity tests carry JAX-made weights across with ``convert``."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        dtype = config.dtype

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
        h = _rmsnorm(x, block["attn_norm"]["scale"])
        b, length, _ = h.shape
        q = (h @ block["wq"]).reshape(b, length, config.n_heads,
                                      config.d_head)
        k = (h @ block["wk"]).reshape(b, length, config.kv_heads,
                                      config.d_head)
        v = (h @ block["wv"]).reshape(b, length, config.kv_heads,
                                      config.d_head)
        q = _rope(q, positions, config.rope_theta)
        k = _rope(k, positions, config.rope_theta)
        attn = (attend(q, k, v) if layer_index is None
                else attend(q, k, v, layer_index))
        attn = attn.reshape(b, length, config.n_heads * config.d_head)
        return x + attn @ block["wo"]

    @staticmethod
    def block_mlp_half(x, block, config: TransformerConfig) -> torch.Tensor:
        """SwiGLU MLP half of a block, residual added."""
        h = _rmsnorm(x, block["mlp_norm"]["scale"])
        gated = F.silu(h @ block["w_gate"]) * (h @ block["w_in"])
        return x + gated @ block["w_out"]

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
        [B, L, d_model] in ``config.dtype``."""
        if positions is None:
            positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=tokens.device
                                     ).expand(tokens.shape)
        x = params["tok_embed"][tokens.long()]

        def attend(q, k, v):
            # GQA is native in the kernel (KV head h // group, no expanded
            # copy); the plain version on CPU tensors expands internally
            return flash_attention(q, k, v, causal=config.causal)

        for block in params["blocks"]:
            x = TransformerLM.block_forward(x, block, config, positions,
                                            attend)
        return _rmsnorm(x, params["final_norm"]["scale"])

    @staticmethod
    def apply(params: Params, tokens: torch.Tensor,
              config: TransformerConfig,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [B, L, vocab] in f32."""
        x = TransformerLM.apply_trunk(params, tokens, config,
                                      positions=positions)
        return _lm_head(x, params["w_lm_head"])
