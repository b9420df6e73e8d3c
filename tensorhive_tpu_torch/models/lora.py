"""LoRA fine-tuning: low-rank adapters over frozen base weights — the
PyTorch counterpart of ``tensorhive_tpu/models/lora.py``.

The adapters are their own tree (``{"blocks": [{name: {"A", "B"}}]}``),
the only tree the optimizer sees: ``lora_loss`` closes over the base
params, which never require a gradient, so ``train.make_train_step`` forms
and applies gradients for A and B alone and the base stays bitwise
unchanged. The forward merges on the fly (``W + (alpha / rank) * A @ B``
per target matrix) and runs the unchanged ``TransformerLM`` math;
``merge`` bakes the adapters into a plain param tree that serving and
``decode.generate`` take like any other.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .transformer import Params, TransformerConfig, TransformerLM

LoraParams = Dict[str, Any]

#: which block matrices get adapters by default — the q and v projections,
#: the original LoRA recipe's choice
DEFAULT_TARGETS = ("wq", "wv")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = DEFAULT_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def init_lora(params: Params, lora_config: LoraConfig,
              generator: Optional[torch.Generator] = None) -> LoraParams:
    """Adapters at the target matrices of every block, f32 on the params'
    device: A [in, rank] Gaussian with std 1/rank, B [rank, out] zeros —
    so the adapted model is exactly the base model at step 0. Draws come
    from ``generator`` (default: seed 0 on the params' device)."""
    device = params["tok_embed"].device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    blocks = []
    for block in params["blocks"]:
        matrices = sorted(name for name, leaf in block.items()
                          if isinstance(leaf, torch.Tensor) and leaf.dim() == 2)
        adapters = {}
        for name in lora_config.targets:
            if name not in matrices:
                raise ValueError(f"no matrix {name!r} in block; targets "
                                 f"must be drawn from {matrices}")
            fan_in, fan_out = block[name].shape
            a = torch.randn((fan_in, lora_config.rank), generator=generator,
                            device=device, dtype=torch.float32)
            adapters[name] = {
                "A": a * (1.0 / lora_config.rank),
                "B": torch.zeros((lora_config.rank, fan_out),
                                 dtype=torch.float32, device=device),
            }
        blocks.append(adapters)
    return {"blocks": blocks}


def merge(params: Params, lora_params: LoraParams,
          lora_config: LoraConfig) -> Params:
    """A new param tree with W + scale * A @ B at every adapted matrix, in
    the matrix's own dtype; every other leaf is the base's own tensor (not
    a copy). Differentiable in A and B."""
    merged = dict(params)
    merged["blocks"] = []
    for block, adapters in zip(params["blocks"], lora_params["blocks"]):
        new_block = dict(block)
        for name, ab in adapters.items():
            delta = (ab["A"] @ ab["B"]) * lora_config.scale
            new_block[name] = block[name] + delta.to(block[name].dtype)
        merged["blocks"].append(new_block)
    return merged


def lora_loss(lora_params: LoraParams, tokens: torch.Tensor,
              config: TransformerConfig, mesh: Any = None, *,
              base_params: Params, lora_config: LoraConfig) -> torch.Tensor:
    """``loss_fn`` for ``train.make_train_step`` with the ADAPTERS as the
    trained tree; bind the base with ``functools.partial(lora_loss,
    base_params=..., lora_config=...)``. The causal LM loss of the merged
    model: gradients reach A and B through the effective weights, and none
    is formed for the base. The adapters under a training mesh (their
    sharding) are not ported yet (ROADMAP A11a-LoRA)."""
    if mesh is not None:
        raise ValueError("lora_loss under a training mesh (sharded "
                         "adapters) is not ported yet: ROADMAP A11a-LoRA")
    merged = merge(base_params, lora_params, lora_config)
    return TransformerLM.loss(merged, tokens, config)
