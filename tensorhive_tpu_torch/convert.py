"""Carry JAX-made weights into the port, and the port's weights back out.

``params_from_jax`` takes the JAX param pytree (``TransformerLM.init``
output) with every leaf already converted to numpy (for example with
``jax.tree_util.tree_map(np.asarray, params)``) and returns the port's
param dict on a device: matmul weights and the embedding in
``param_dtype`` — ``config.dtype`` by default (serving), ``torch.float32``
to carry JAX's f32 masters across unrounded (training) — and norm scales
kept f32; see ``models/transformer``.
``lora_from_jax`` / ``lora_to_numpy`` do the same for LoRA adapter trees
(``models/lora``), which stay f32. ``config_from_jax`` carries a JAX
``TransformerConfig`` across, field by field.
Nothing here imports JAX; the caller does the JAX-side conversion.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.transformer import Params, TransformerConfig

_BLOCK_MATMULS = ("wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out")
_BLOCK_NORMS = ("attn_norm", "mlp_norm")


def config_from_jax(jax_config: Any, **overrides: Any) -> TransformerConfig:
    """The port's ``TransformerConfig`` of a JAX one: every field both
    define (``pp_microbatches`` included), the dtype by name; fields only
    JAX has (``use_flash``: the port always runs its kernels) are dropped.
    ``overrides`` replace fields afterwards."""
    values = {}
    for field in dataclasses.fields(TransformerConfig):
        if not hasattr(jax_config, field.name):
            continue
        value = getattr(jax_config, field.name)
        if field.name == "dtype":
            value = getattr(torch, np.dtype(value).name)
        values[field.name] = value
    values.update(overrides)
    return TransformerConfig(**values)


def params_from_jax(tree: Dict[str, Any], config: TransformerConfig,
                    device: DeviceLike = None,
                    param_dtype: Optional[torch.dtype] = None) -> Params:
    """JAX pytree of numpy arrays -> port params on ``device``."""
    device = resolve_device(device)
    dtype = config.dtype if param_dtype is None else param_dtype
    if len(tree["blocks"]) != config.n_layers:
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, config "
                         f"{config.n_layers} layers")

    def weight(array) -> torch.Tensor:
        return torch.tensor(np.asarray(array, np.float32)).to(
            device=device, dtype=dtype)

    def norm(node) -> Dict[str, torch.Tensor]:
        return {"scale": torch.tensor(
            np.asarray(node["scale"], np.float32)).to(device)}

    expected = {
        "tok_embed": (config.vocab_size, config.d_model),
        "w_lm_head": (config.d_model, config.vocab_size),
    }
    for name, shape in expected.items():
        if tuple(np.shape(tree[name])) != shape:
            raise ValueError(f"{name} has shape {np.shape(tree[name])}, "
                             f"config wants {shape}")
    return {
        "tok_embed": weight(tree["tok_embed"]),
        "final_norm": norm(tree["final_norm"]),
        "w_lm_head": weight(tree["w_lm_head"]),
        "blocks": [
            {**{name: weight(block[name]) for name in _BLOCK_MATMULS},
             **{name: norm(block[name]) for name in _BLOCK_NORMS}}
            for block in tree["blocks"]],
    }


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """Port params -> the JAX pytree layout with f32 numpy leaves."""
    def array(tensor: torch.Tensor) -> np.ndarray:
        return tensor.detach().to(device="cpu", dtype=torch.float32).numpy()

    return {
        "tok_embed": array(params["tok_embed"]),
        "final_norm": {"scale": array(params["final_norm"]["scale"])},
        "w_lm_head": array(params["w_lm_head"]),
        "blocks": [
            {**{name: array(block[name]) for name in _BLOCK_MATMULS},
             **{name: {"scale": array(block[name]["scale"])}
                for name in _BLOCK_NORMS}}
            for block in params["blocks"]],
    }


def lora_from_jax(tree: Dict[str, Any],
                  device: DeviceLike = None) -> Dict[str, Any]:
    """JAX adapter tree ``{"blocks": [{name: {"A", "B"}}]}`` of numpy
    arrays -> the port's adapter tree on ``device``, f32 as ``init_lora``
    makes it."""
    device = resolve_device(device)

    def leaf(array) -> torch.Tensor:
        return torch.tensor(np.asarray(array, np.float32)).to(device)

    return {"blocks": [
        {name: {"A": leaf(ab["A"]), "B": leaf(ab["B"])}
         for name, ab in block.items()}
        for block in tree["blocks"]]}


def lora_to_numpy(lora_params: Dict[str, Any]) -> Dict[str, Any]:
    """Port adapter tree -> the JAX layout with f32 numpy leaves."""
    def array(tensor: torch.Tensor) -> np.ndarray:
        return tensor.detach().to(device="cpu", dtype=torch.float32).numpy()

    return {"blocks": [
        {name: {"A": array(ab["A"]), "B": array(ab["B"])}
         for name, ab in block.items()}
        for block in lora_params["blocks"]]}
