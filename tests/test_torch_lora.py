"""The port's LoRA fine-tuning against the JAX package.

JAX-made f32 base weights (``tiny``, GQA) are carried in with
``params_from_jax`` and JAX adapter trees with ``lora_from_jax``. On the
same tokens:

* ``lora_loss`` and its adapter gradients agree with ``jax.value_and_grad``
  of the JAX ``lora_loss`` within 1e-5 relative (B made nonzero so that A
  has a gradient too);
* 3 steps of ``make_train_step`` over the adapters agree with the JAX
  steps (loss and grad_norm within 1e-5 relative, adapters per leaf on
  average, as ``test_torch_train.py``), and the base stays bitwise
  unchanged;
* ``merge`` is W + (alpha / rank) * A @ B computed in numpy, and the
  merged tree decodes the tokens the JAX merged tree decodes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu import train as jax_train
from tensorhive_tpu.models import decode as jax_decode
from tensorhive_tpu.models import lora as jax_lora
from tensorhive_tpu.models.transformer import PRESETS as JAX_PRESETS
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu_torch import train
from tensorhive_tpu_torch.convert import (
    lora_from_jax,
    lora_to_numpy,
    params_from_jax,
)
from tensorhive_tpu_torch.models import decode, lora
from tensorhive_tpu_torch.models.transformer import PRESETS, TransformerLM

REL_TOL = 1e-5
LORA = lora.LoraConfig(rank=4, alpha=8.0)


def setup(seed=0, nonzero_b=True):
    """(jax_config, config, jax base, port base, jax adapters, port
    adapters), the adapters' B drawn from numpy when ``nonzero_b``."""
    jax_config = dataclasses.replace(
        JAX_PRESETS["tiny"], dtype=jnp.float32, use_flash=False, remat=False,
        max_seq_len=64, n_kv_heads=2, loss_chunk_tokens=0)
    config = dataclasses.replace(
        PRESETS["tiny"], dtype=torch.float32, remat=False, max_seq_len=64,
        n_kv_heads=2, loss_chunk_tokens=0)
    jax_base = JaxLM.init(jax.random.PRNGKey(seed), jax_config)
    tree = jax.tree_util.tree_map(np.asarray, jax_base)
    jax_adapters = jax_lora.init_lora(jax.random.PRNGKey(seed + 1), jax_base,
                                      jax_lora.LoraConfig(rank=4, alpha=8.0))
    if nonzero_b:
        rng = np.random.default_rng(seed)
        jax_adapters = jax.tree_util.tree_map_with_path(
            lambda path, leaf: jnp.asarray(
                rng.standard_normal(leaf.shape, np.float32) * 0.05)
            if path[-1].key == "B" else leaf, jax_adapters)
    adapters = lora_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_adapters), "cpu")
    base = params_from_jax(tree, config, "cpu", param_dtype=torch.float32)
    return jax_config, config, jax_base, base, jax_adapters, adapters


def tokens_for(config, batch, length, seed):
    return np.random.default_rng(seed).integers(
        0, config.vocab_size, (batch, length + 1), dtype=np.int32)


def test_init_shapes_and_zero_b_identity():
    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32)
    base = TransformerLM.init(config, torch.Generator().manual_seed(0),
                              device="cpu")
    adapters = lora.init_lora(base, LORA, torch.Generator().manual_seed(1))
    assert len(adapters["blocks"]) == config.n_layers
    for block, ab in zip(base["blocks"], adapters["blocks"]):
        assert sorted(ab) == ["wq", "wv"]
        for name in ab:
            fan_in, fan_out = block[name].shape
            assert ab[name]["A"].shape == (fan_in, 4)
            assert ab[name]["B"].shape == (4, fan_out)
            assert ab[name]["A"].dtype == torch.float32
            assert not ab[name]["B"].any()
    a = torch.cat([ab[n]["A"].flatten() for ab in adapters["blocks"]
                   for n in ab])
    assert abs(a.std().item() - 1 / 4) < 0.02         # std 1/rank
    merged = lora.merge(base, adapters, LORA)
    for got, want in zip(train.tree_leaves(merged), train.tree_leaves(base)):
        assert torch.equal(got, want)
    tokens = torch.from_numpy(tokens_for(config, 2, 16, 0))
    with torch.no_grad():
        assert torch.equal(
            lora.lora_loss(adapters, tokens, config, base_params=base,
                           lora_config=LORA),
            TransformerLM.loss(base, tokens, config))


def test_targets_are_validated():
    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32)
    base = TransformerLM.init(config, device="cpu")
    with pytest.raises(ValueError, match="no matrix 'w_bogus'"):
        lora.init_lora(base, dataclasses.replace(LORA, targets=("w_bogus",)))
    with pytest.raises(ValueError, match="no matrix 'attn_norm'"):
        lora.init_lora(base, dataclasses.replace(LORA, targets=("attn_norm",)))
    every = lora.init_lora(base, dataclasses.replace(
        LORA, targets=("wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out")))
    assert len(every["blocks"][0]) == 7


def test_merge_is_w_plus_scaled_a_b():
    _, config, _, base, jax_adapters, adapters = setup(2)
    merged = lora.merge(base, adapters, LORA)
    numpy_adapters = lora_to_numpy(adapters)
    for block, got, ab in zip(base["blocks"], merged["blocks"],
                              numpy_adapters["blocks"]):
        for name in ("wq", "wv"):
            want = (block[name].numpy()
                    + (ab[name]["A"] @ ab[name]["B"]) * (8.0 / 4))
            np.testing.assert_allclose(got[name].numpy(), want, rtol=1e-6,
                                       atol=1e-7)
        assert got["wk"] is block["wk"]               # untouched leaves shared
    for got, want in zip(jax.tree_util.tree_leaves(numpy_adapters),
                         jax.tree_util.tree_leaves(jax_adapters)):
        assert np.array_equal(got, np.asarray(want))   # f32 round trip


def test_lora_loss_and_adapter_grads_match_jax():
    jax_config, config, jax_base, base, jax_adapters, adapters = setup(3)
    tokens = tokens_for(config, 2, 24, 3)
    jax_loss = functools.partial(jax_lora.lora_loss, base_params=jax_base,
                                 lora_config=jax_lora.LoraConfig(4, 8.0))
    value, grads = jax.jit(jax.value_and_grad(jax_loss), static_argnums=2)(
        jax_adapters, jnp.asarray(tokens), jax_config)
    live = train.tree_map(lambda t: t.requires_grad_(), adapters)
    loss = lora.lora_loss(live, torch.from_numpy(tokens), config,
                          base_params=base, lora_config=LORA)
    ours = torch.autograd.grad(loss, train.tree_leaves(live))
    np.testing.assert_allclose(loss.item(), float(value), rtol=REL_TOL)
    for got, want in zip(ours, jax.tree_util.tree_leaves(grads)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=REL_TOL * np.abs(want).max(),
                                   rtol=REL_TOL)


def test_train_steps_match_jax_and_keep_the_base_frozen():
    jax_config, config, jax_base, base, _, _ = setup(4, nonzero_b=False)
    jax_adapters = jax_lora.init_lora(jax.random.PRNGKey(9), jax_base,
                                      jax_lora.LoraConfig(4, 8.0))
    adapters = lora_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_adapters), "cpu")
    knobs = dict(batch_size=4, seq_len=24, warmup_steps=1, total_steps=10,
                 learning_rate=1e-2)
    jax_tc = jax_train.TrainConfig(**knobs)
    tc = train.TrainConfig(**knobs)
    j_step = jax_train.make_train_step(jax_config, jax_tc, loss_fn=(
        functools.partial(jax_lora.lora_loss, base_params=jax_base,
                          lora_config=jax_lora.LoraConfig(4, 8.0))))
    step = train.make_train_step(config, tc, loss_fn=functools.partial(
        lora.lora_loss, base_params=base, lora_config=LORA))
    j_opt = jax_train.make_optimizer(jax_tc).init(jax_adapters)
    opt_state = train.make_optimizer(tc).init(adapters)
    frozen = [leaf.clone() for leaf in train.tree_leaves(base)]
    tokens = tokens_for(config, 4, 24, 4)
    lr_sum = 0.0
    for index in range(3):
        jax_adapters, j_opt, j_metrics = j_step(jax_adapters, j_opt,
                                                jnp.asarray(tokens))
        adapters, opt_state, metrics = step(adapters, opt_state,
                                            torch.from_numpy(tokens))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(j_metrics[key]), rtol=REL_TOL)
        lr_sum += train.make_optimizer(tc).learning_rate(index)
        for got, want in zip(
                jax.tree_util.tree_leaves(lora_to_numpy(adapters)),
                jax.tree_util.tree_leaves(jax_adapters)):
            assert np.abs(got - np.asarray(want)).mean() <= 1e-3 * lr_sum
    assert opt_state["count"] == 3
    assert any(ab[n]["B"].any() for ab in adapters["blocks"] for n in ab)
    for leaf, before in zip(train.tree_leaves(base), frozen):
        assert torch.equal(leaf, before) and not leaf.requires_grad


def test_merged_tree_generates_what_jax_generates():
    jax_config, config, jax_base, base, jax_adapters, adapters = setup(5)
    jax_merged = jax_lora.merge(jax_base, jax_adapters,
                                jax_lora.LoraConfig(4, 8.0))
    merged = lora.merge(base, adapters, LORA)
    prompt = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]]
    expected = np.asarray(jax_decode.generate(
        jax_merged, jax_config, jnp.asarray(prompt, jnp.int32),
        max_new_tokens=8))
    with torch.no_grad():
        out = decode.generate(merged, config, prompt, max_new_tokens=8,
                              device="cpu")
        plain = decode.generate(base, config, prompt, max_new_tokens=8,
                                device="cpu")
    assert out.tolist() == expected.tolist()
    assert out.tolist() != plain.tolist()          # the adapters matter
