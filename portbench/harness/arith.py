"""The yardstick's arithmetic, frozen: the card's peaks, the model FLOPs
of a trained token, the flash kernels' FLOP bounds, the paged-decode byte
bound and the decode step's roofline. Copies, not imports, of the program's
formulas (``models/transformer.py::train_flops_per_token``, the bounds of
``chip_smoke.py``'s kernels phase), so that a change to the program cannot
move the ruler it is measured with.

Shapes come from a configuration file (the Hugging Face key names).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable

#: NVIDIA H100 SXM, dense bf16 tensor-core rate and HBM3 bandwidth (the
#: data sheet, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


@dataclass(frozen=True)
class Shape:
    hidden: int
    intermediate: int
    layers: int
    heads: int
    kv_heads: int
    vocab: int

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @classmethod
    def of(cls, config: Dict) -> "Shape":
        return cls(hidden=config["hidden_size"],
                   intermediate=config["intermediate_size"],
                   layers=config["num_hidden_layers"],
                   heads=config["num_attention_heads"],
                   kv_heads=config["num_key_value_heads"],
                   vocab=config["vocab_size"])


def layer_matmul_params(shape: Shape) -> int:
    """Weights of one block's matmuls: Q, K, V, O and the SwiGLU MLP."""
    d, dh = shape.hidden, shape.head_dim
    attention = d * shape.heads * dh * 2 + d * shape.kv_heads * dh * 2
    return attention + 3 * d * shape.intermediate


def matmul_params(shape: Shape) -> int:
    """Every weight a token's forward multiplies: the blocks and the LM
    head (the embedding is a gather)."""
    return shape.layers * layer_matmul_params(shape) + shape.hidden * shape.vocab


def param_count(shape: Shape) -> int:
    """All parameters: embedding, untied head, blocks with their two norm
    scales, the final norm."""
    return (2 * shape.vocab * shape.hidden
            + shape.layers * (layer_matmul_params(shape) + 2 * shape.hidden)
            + shape.hidden)


def train_flops_per_token(shape: Shape, seq_len: int) -> float:
    """Model FLOPs of one trained token, recomputation not counted:
    forward Q+O 4·D², K+V 4·D·Hkv·Dh, SwiGLU 6·D·F, the causal attention
    core 2·S·D, the head 2·D·V; training is three forwards."""
    d = shape.hidden
    kv_dim = shape.kv_heads * shape.head_dim
    per_layer = (4 * d * d + 4 * d * kv_dim + 6 * d * shape.intermediate
                 + 2 * seq_len * d)
    return 3.0 * (shape.layers * per_layer + 2 * d * shape.vocab)


def flash_fwd_flops(batch: int, seq: int, heads: int, head_dim: int) -> float:
    """Causal attention forward: Q Kᵀ and P V, 4·S²·H·D·B, halved."""
    return 4.0 * seq * seq * heads * head_dim * batch / 2


def flash_bwd_flops(batch: int, seq: int, heads: int, head_dim: int) -> float:
    """Causal attention backward: S and P again, dV, dP, dQ and dK,
    10·S²·H·D·B, halved."""
    return 10.0 * seq * seq * heads * head_dim * batch / 2


def paged_decode_bytes(context: int, shape: Shape, page_size: int,
                       kv_itemsize: int = 1, scale_bytes: int = 4,
                       entry_bytes: int = 4, q_itemsize: int = 2) -> float:
    """Bytes one decoded token's paged attention needs over all layers: its
    ``context`` K and V rows (int8: one byte a cell) with each page's K and
    V scale per KV head, its page-table entries, q and the output, each
    counted once."""
    pages = math.ceil(context / page_size)
    rows = 2 * context * shape.kv_heads * shape.head_dim * kv_itemsize
    scales = 2 * pages * shape.kv_heads * scale_bytes
    table = pages * entry_bytes
    q_and_out = 2 * shape.heads * shape.head_dim * q_itemsize
    return float(shape.layers * (rows + scales + table + q_and_out))


def decode_attention_flops(context: int, shape: Shape) -> float:
    """Q Kᵀ and P V of one decoded token over ``context`` keys, all
    layers."""
    return 4.0 * context * shape.heads * shape.head_dim * shape.layers


def decode_tick_bound_s(contexts: Iterable[int], shape: Shape,
                        page_size: int, weight_itemsize: int = 2) -> float:
    """Least time of one decode step that emits a token for each of
    ``contexts``: the larger of its FLOPs at the bf16 peak (2 × matmul
    weights a token, plus attention) and its bytes at HBM bandwidth (every
    weight read once, plus each token's paged-attention bytes)."""
    contexts = list(contexts)
    if not contexts:
        return 0.0
    flops = sum(2.0 * matmul_params(shape) + decode_attention_flops(c, shape)
                for c in contexts)
    weight_bytes = (matmul_params(shape) + shape.layers * 2 * shape.hidden
                    + shape.hidden) * weight_itemsize
    kv_bytes = sum(paged_decode_bytes(c, shape, page_size) for c in contexts)
    return max(flops / PEAK_BF16_FLOPS,
               (weight_bytes + kv_bytes) / PEAK_HBM_BYTES_PER_S)
