"""The port's bf16 compute against JAX's, both held to JAX's f32 result.

The card's main paths compute in bf16 (f32 masters, bf16 activations and
matmuls), while the parity tests elsewhere run f32 configs. Here the same
JAX-made f32 weights and tokens (B 4 x S 128) go through JAX's forward and
loss gradient in f32 (the reference) and in bf16, and through the port's
in bf16 (on CPU tensors: the plain versions the kernels are held to on the
card). Two libraries round bf16 at different places, so the port's bf16
result is not JAX's; what is held is its distance from the f32 reference:
the logits (||Δ|| / ||ref||), the loss (|Δ|), the gradients over all leaves
(||Δ|| / ||ref||) and each gradient leaf may sit no further from it than
BF16_FACTOR times JAX's own bf16 error. Measured on this CPU (the port
against JAX): logits 1.28% against 1.32% (``tiny`` MHA), 1.38% against
1.42% (GQA), 1.29% against 1.32% (d_head 80, group 3); every gradient leaf
within 1.17 times JAX's error.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu.models.transformer import PRESETS as JAX_PRESETS
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu_torch import train
from tensorhive_tpu_torch.convert import params_from_jax
from tensorhive_tpu_torch.models.transformer import PRESETS, TransformerLM

#: how much further from JAX's f32 result the port's bf16 result may sit
#: than JAX's own bf16 result does
BF16_FACTOR = 1.5

#: ``tiny`` MHA and GQA, and ``tiny`` at d_head 80 over GQA groups of 3
#: (d_model 480, 6 heads over 2 KV heads): a width the kernels run padded
SHAPES = {"mha": {}, "gqa": {"n_kv_heads": 2},
          "d80-group3": {"d_model": 480, "n_heads": 6, "n_kv_heads": 2,
                         "d_ff": 1280}}


def relative(error, reference):
    return (np.linalg.norm(np.concatenate([e.ravel() for e in error]))
            / np.linalg.norm(np.concatenate([r.ravel() for r in reference])))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_bf16_logits_loss_and_grads_sit_as_near_f32_as_jax(shape):
    base = dataclasses.replace(JAX_PRESETS["tiny"], use_flash=False,
                               remat=False, max_seq_len=256, **SHAPES[shape])
    jax_f32 = dataclasses.replace(base, dtype=jnp.float32)
    jax_bf16 = dataclasses.replace(base, dtype=jnp.bfloat16)
    config = dataclasses.replace(PRESETS["tiny"], remat=False,
                                 max_seq_len=256, dtype=torch.bfloat16,
                                 **SHAPES[shape])
    params = JaxLM.init(jax.random.PRNGKey(0), jax_f32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tokens = np.random.default_rng(0).integers(
        0, base.vocab_size, (4, 129), dtype=np.int32)
    inputs = tokens[:, :-1]

    def to_port():
        return params_from_jax(tree, config, "cpu",
                               param_dtype=torch.float32)

    # logits
    reference = np.asarray(JaxLM.apply(params, jnp.asarray(inputs), jax_f32),
                           np.float64)
    theirs = np.asarray(JaxLM.apply(params, jnp.asarray(inputs), jax_bf16),
                        np.float64)
    ours = TransformerLM.apply(to_port(), torch.from_numpy(inputs),
                               config).double().numpy()
    jax_error = relative([theirs - reference], [reference])
    port_error = relative([ours - reference], [reference])
    assert port_error <= BF16_FACTOR * jax_error, (port_error, jax_error)

    # loss and gradients
    f32_loss, f32_grads = jax.value_and_grad(JaxLM.loss)(
        params, jnp.asarray(tokens), jax_f32)
    bf16_loss, bf16_grads = jax.value_and_grad(JaxLM.loss)(
        params, jnp.asarray(tokens), jax_bf16)
    live = jax.tree_util.tree_map(lambda t: t.requires_grad_(), to_port())
    loss = TransformerLM.loss(live, torch.from_numpy(tokens), config)
    grads = torch.autograd.grad(loss, train.tree_leaves(live))
    assert abs(loss.item() - float(f32_loss)) <= BF16_FACTOR * abs(
        float(bf16_loss) - float(f32_loss))
    want = [np.asarray(g, np.float64) for g in jax.tree_util.tree_leaves(
        f32_grads)]                           # both in sorted-key order
    theirs = [np.asarray(g, np.float64) - w for g, w in zip(
        jax.tree_util.tree_leaves(bf16_grads), want)]
    ours = [g.double().numpy() - w for g, w in zip(grads, want)]
    assert relative(ours, want) <= BF16_FACTOR * relative(theirs, want)
    for mine, jax_leaf, ref in zip(ours, theirs, want):
        assert (relative([mine], [ref])
                <= BF16_FACTOR * relative([jax_leaf], [ref]))
