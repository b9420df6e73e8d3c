"""Weights from ``--seed``, made on the device in the port's layout.

One generator per layer draws that layer's matmul weights in one call (and
one each the embedding and the head), so a leaf can be drawn again alone:
the reference takes its weights this way, never from the program. The
draws follow the port's ``TransformerLM.init`` distributions (embedding
N(0, 0.02²), weights N(0, 1/fan_in), norm scales 1) in the ``[in, out]``
layout, and are rounded to the served type after the draw.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .arith import Shape

#: the block's matmul leaves in draw order: (name, rows, columns)
def layer_leaves(shape: Shape) -> List[Tuple[str, int, int]]:
    d, dh, f = shape.hidden, shape.head_dim, shape.intermediate
    return [("wq", d, shape.heads * dh), ("wk", d, shape.kv_heads * dh),
            ("wv", d, shape.kv_heads * dh), ("wo", shape.heads * dh, d),
            ("w_in", d, f), ("w_gate", d, f), ("w_out", f, d)]


def derive(seed: int, *tags: int) -> int:
    """A 63-bit generator seed from the run's seed and a stream's tags."""
    entropy = [seed % (1 << 64), *tags]
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0] >> 1)


def generator(seed: int, device: torch.device, *tags: int
              ) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def layer(shape: Shape, seed: int, index: int, device: torch.device,
          dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Block ``index``'s leaves. In f32 the leaves are views of one drawn
    buffer; in another type each is rounded from it."""
    leaves = layer_leaves(shape)
    total = sum(rows * cols for _, rows, cols in leaves)
    flat = torch.randn(total, generator=generator(seed, device, 1, index),
                       device=device, dtype=torch.float32)
    block: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, rows, cols in leaves:
        leaf = flat[offset:offset + rows * cols].view(rows, cols)
        leaf.mul_(1.0 / math.sqrt(rows))
        block[name] = leaf if dtype == torch.float32 else leaf.to(dtype)
        offset += rows * cols
    for norm in ("attn_norm", "mlp_norm"):
        block[norm] = {"scale": torch.ones(shape.hidden, dtype=torch.float32,
                                           device=device)}
    return block


def embedding(shape: Shape, seed: int, device: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
    table = torch.randn(shape.vocab, shape.hidden,
                        generator=generator(seed, device, 2), device=device,
                        dtype=torch.float32).mul_(0.02)
    return table if dtype == torch.float32 else table.to(dtype)


def head(shape: Shape, seed: int, device: torch.device,
         dtype: torch.dtype) -> torch.Tensor:
    weight = torch.randn(shape.hidden, shape.vocab,
                         generator=generator(seed, device, 3), device=device,
                         dtype=torch.float32).mul_(1.0 / math.sqrt(shape.hidden))
    return weight if dtype == torch.float32 else weight.to(dtype)


def params(shape: Shape, seed: int, device: torch.device,
           dtype: torch.dtype) -> Dict:
    """The whole tree in the port's layout (``TransformerLM.init``'s)."""
    return {"tok_embed": embedding(shape, seed, device, dtype),
            "final_norm": {"scale": torch.ones(shape.hidden,
                                               dtype=torch.float32,
                                               device=device)},
            "w_lm_head": head(shape, seed, device, dtype),
            "blocks": [layer(shape, seed, index, device, dtype)
                       for index in range(shape.layers)]}
