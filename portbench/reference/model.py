"""The block the configurations name, written out in plain PyTorch: pre
RMSNorm, rotary embedding on interleaved pairs, grouped-query causal
attention, SwiGLU, an untied head. Weights are ``[in, out]`` (``x @ w``).

``quant`` set to ``"fp8"`` rounds every matmul's operands to float8 e4m3
(weights per output column, activations per row, each scaled to the
format's range): the control, the precision below the configuration's
bf16. The rounding passes gradients straight through.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def exact_f32() -> None:
    """float32 matmuls in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale per slice along ``dim``
    (amax to the format's largest value); gradients pass straight."""
    scale = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = scale / FP8_MAX
    rounded = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (rounded - x).detach()


def matmul(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]
           ) -> torch.Tensor:
    if quant == "fp8":
        return fp8_round(x, -1) @ fp8_round(w, 0)
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """[L, H, D] rotated on the pairs (x[2i], x[2i + 1])."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                    device=x.device) / d)
    angles = (positions.to(torch.float64)[:, None] * freqs)[:, None, :]
    cos, sin = torch.cos(angles).to(x.dtype), torch.sin(angles).to(x.dtype)
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack([even * cos - odd * sin, even * sin + odd * cos],
                       dim=-1).reshape(x.shape)


#: queries attended at once: the scores of a block of them fit, at any
#: sequence length, forward and backward
QUERY_BLOCK = 1024


def _attend_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  first: int) -> torch.Tensor:
    """Queries at positions ``first ..`` over the keys up to the last of
    them, masked causally."""
    keys = first + q.shape[0]
    scores = torch.einsum("qhd,khd->hqk", q, k[:keys]) * q.shape[-1] ** -0.5
    rows = torch.arange(first, keys, device=q.device)[:, None]
    mask = torch.arange(keys, device=q.device)[None, :] <= rows
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1),
                        v[:keys])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Causal attention of [L, H, D] queries over [L, Hkv, D] keys and
    values; query head h reads KV head h // (H / Hkv)."""
    group = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    out = []
    for first in range(0, q.shape[0], QUERY_BLOCK):
        part = q[first:first + QUERY_BLOCK]
        if torch.is_grad_enabled():
            out.append(checkpoint(_attend_block, part, k, v, first,
                                  use_reentrant=False))
        else:
            out.append(_attend_block(part, k, v, first))
    return torch.cat(out)


def block(x: torch.Tensor, weights: Dict, positions: torch.Tensor,
          heads: int, kv_heads: int, theta: float, eps: float,
          quant: Optional[str] = None) -> torch.Tensor:
    """One block over one sequence, [L, D] -> [L, D]."""
    length, d = x.shape
    d_head = d // heads
    h = rmsnorm(x, weights["attn_norm"]["scale"], eps)
    q = matmul(h, weights["wq"], quant).reshape(length, heads, d_head)
    k = matmul(h, weights["wk"], quant).reshape(length, kv_heads, d_head)
    v = matmul(h, weights["wv"], quant).reshape(length, kv_heads, d_head)
    attn = attention(rope(q, positions, theta), rope(k, positions, theta), v)
    x = x + matmul(attn.reshape(length, heads * d_head), weights["wo"], quant)
    h = rmsnorm(x, weights["mlp_norm"]["scale"], eps)
    gated = (torch.nn.functional.silu(matmul(h, weights["w_gate"], quant))
             * matmul(h, weights["w_in"], quant))
    return x + matmul(gated, weights["w_out"], quant)


def read_logits(sequences: Sequence[Sequence[int]],
                read: Sequence[Sequence[int]], embed: torch.Tensor,
                load_layer: Callable[[int], Dict], layers: int,
                final_scale: torch.Tensor, head: torch.Tensor, heads: int,
                kv_heads: int, theta: float, eps: float,
                quant: Optional[str] = None) -> List[torch.Tensor]:
    """Logits [len(read[i]), V] at positions ``read[i]`` of each sequence,
    layer by layer over all sequences (each layer's weights loaded once by
    ``load_layer``, f32)."""
    device = embed.device
    states = [embed[torch.as_tensor(list(tokens), device=device).long()]
              for tokens in sequences]
    with torch.no_grad():
        for index in range(layers):
            weights = load_layer(index)
            states = [block(x, weights, torch.arange(x.shape[0],
                                                      device=device),
                            heads, kv_heads, theta, eps, quant)
                      for x in states]
            del weights
        out = []
        for x, rows in zip(states, read):
            rows = torch.as_tensor(list(rows), device=device).long()
            out.append(matmul(rmsnorm(x[rows], final_scale, eps), head,
                              quant))
    return out


def loss_sum(params: Dict, tokens: torch.Tensor, heads: int, kv_heads: int,
             theta: float, eps: float, quant: Optional[str] = None
             ) -> torch.Tensor:
    """Sum over one row's positions of the next-token cross entropy
    (logsumexp minus the target's logit); ``tokens`` is [S + 1]. Each
    block is recomputed in the backward, so a row's activations fit."""
    inputs, targets = tokens[:-1].long(), tokens[1:].long()
    positions = torch.arange(inputs.shape[0], device=tokens.device)
    x = params["tok_embed"][inputs]
    for weights in params["blocks"]:
        x = checkpoint(block, x, weights, positions, heads, kv_heads, theta,
                       eps, quant, use_reentrant=False)
    x = rmsnorm(x, params["final_norm"]["scale"], eps)
    logits = matmul(x, params["w_lm_head"], quant)
    target = torch.gather(logits, -1, targets[:, None])[:, 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - target)
