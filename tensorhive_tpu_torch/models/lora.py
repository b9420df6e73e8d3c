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

Under a training mesh the adapters are whole on every rank (JAX's
``param_sharding`` replicates a leaf it has no logical axes for), and a pp
rank holds its stage's layers' adapters: at ``7b`` widths, rank 8 on
wq/wv, they are 0.43 MB a layer, 1.28 MB with Adam's moments. The base is
the rank's shard; each rank adds ``A[rows] @ B[:, cols]`` for its block of
a target matrix only (``TrainParallel.adapter_blocks``), never the whole
product.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..parallel.mesh import train_spec, whole_shape
from ..parallel.train_parallel import TrainParallel
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
              generator: Optional[torch.Generator] = None,
              mesh: Any = None) -> LoraParams:
    """Adapters at the target matrices of every block, f32 on the params'
    device: A [in, rank] Gaussian with std 1/rank, B [rank, out] zeros —
    so the adapted model is exactly the base model at step 0. Draws come
    from ``generator`` (default: seed 0 on the params' device; none on the
    ``meta`` device, which gives templates for ``restore_checkpoint``).

    On a training ``mesh`` ``params`` is a rank's shard: A is drawn at the
    whole matrix's shape for every layer of the model, in order, and a pp
    rank keeps its stage's layers, so one seed gives the same adapters on
    any mesh and on one device."""
    device = params["tok_embed"].device
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    held = params["blocks"]
    total = len(held) * (mesh.pp if mesh is not None else 1)
    layers = mesh.stage_layers(total) if mesh is not None else range(total)
    matrices = sorted(name for name, leaf in held[0].items()
                      if isinstance(leaf, torch.Tensor) and leaf.dim() == 2)
    for name in lora_config.targets:
        if name not in matrices:
            raise ValueError(f"no matrix {name!r} in block; targets must be "
                             f"drawn from {matrices}")
    blocks = []
    for index in range(total):
        adapters = {}
        for name in lora_config.targets:
            shape = tuple(held[0][name].shape)
            if mesh is not None:
                shape = whole_shape(shape, train_spec(name, 2), mesh)
            fan_in, fan_out = shape
            a = torch.randn((fan_in, lora_config.rank), generator=generator,
                            device=device, dtype=torch.float32)
            adapters[name] = {
                "A": a * (1.0 / lora_config.rank),
                "B": torch.zeros((lora_config.rank, fan_out),
                                 dtype=torch.float32, device=device),
            }
        if index in layers:
            blocks.append(adapters)
    return {"blocks": blocks}


def merge(params: Params, lora_params: LoraParams,
          lora_config: LoraConfig, mesh: Any = None) -> Params:
    """A new param tree with W + scale * A @ B at every adapted matrix, in
    the matrix's own dtype; every other leaf is the base's own tensor (not
    a copy). Differentiable in A and B. On a training ``mesh`` ``params``
    is a rank's shard and each adapted block gets its own block of the
    product."""
    par = TrainParallel(mesh) if mesh is not None else None
    merged = dict(params)
    merged["blocks"] = []
    for block, adapters in zip(params["blocks"], lora_params["blocks"]):
        new_block = dict(block)
        for name, ab in adapters.items():
            a, b = ab["A"], ab["B"]
            if par is not None:
                a, b = par.adapter_blocks(a, b, name)
            delta = (a @ b) * lora_config.scale
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
    is formed for the base. On a training ``mesh`` ``base_params`` is the
    rank's shard and ``tokens`` its rows, as for ``TransformerLM.loss``."""
    merged = merge(base_params, lora_params, lora_config, mesh)
    return TransformerLM.loss(merged, tokens, config, mesh)
