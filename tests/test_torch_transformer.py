"""The port's transformer against the JAX model, and the weight bridge.

JAX-made f32 weights (``tiny`` preset, MHA and GQA) are carried into the
port with ``convert.params_from_jax``; ``TransformerLM.apply`` logits on
the same tokens agree with the JAX ``TransformerLM.apply`` within 1e-5 abs
(accumulation order of the two libraries' CPU matmuls only). The JAX side
runs its reference attention (``use_flash=False``); the JAX tests pin its
flash kernel to that reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu.models.transformer import PRESETS as JAX_PRESETS
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu_torch.convert import params_from_jax, params_to_numpy
from tensorhive_tpu_torch.models.transformer import (
    PRESETS,
    TransformerLM,
    _rope,
)

TOL = 1e-5


def setup(kv_heads, dtype=torch.float32):
    jax_config = dataclasses.replace(
        JAX_PRESETS["tiny"], dtype=jnp.float32, use_flash=False, remat=False,
        max_seq_len=128, n_kv_heads=kv_heads)
    config = dataclasses.replace(PRESETS["tiny"], dtype=dtype,
                                 max_seq_len=128, n_kv_heads=kv_heads)
    jax_params = JaxLM.init(jax.random.PRNGKey(3), jax_config)
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    return jax_config, config, jax_params, tree


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_apply_logits_match_jax(kv_heads):
    jax_config, config, jax_params, tree = setup(kv_heads)
    tokens = np.random.default_rng(0).integers(0, config.vocab_size, (2, 24),
                                               dtype=np.int32)
    expected = np.asarray(JaxLM.apply(jax_params, jnp.asarray(tokens),
                                      jax_config))
    model = TransformerLM(config, params_from_jax(tree, config, "cpu"),
                          device="cpu")
    logits = model(torch.from_numpy(tokens))
    assert logits.shape == (2, 24, config.vocab_size)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), expected, atol=TOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_params_from_jax_round_trip(dtype):
    _, config, _, tree = setup(2, dtype)
    params = params_from_jax(tree, config, device="cpu")
    # matmul weights and the embedding in config.dtype, norm scales f32
    assert params["tok_embed"].dtype == dtype
    assert params["blocks"][0]["wk"].dtype == dtype
    assert params["blocks"][0]["wk"].shape == (config.d_model,
                                               2 * config.d_head)
    assert params["final_norm"]["scale"].dtype == torch.float32
    back = params_to_numpy(params)
    flat_back = jax.tree_util.tree_leaves(back)
    flat_tree = jax.tree_util.tree_leaves(tree)
    assert len(flat_back) == len(flat_tree)
    for ours, theirs in zip(flat_back, flat_tree):
        if dtype == torch.float32:
            assert np.array_equal(ours, theirs)
        else:   # one bf16 rounding, nothing else
            np.testing.assert_allclose(ours, theirs, rtol=2 ** -8, atol=0)
    bad = dict(tree, blocks=tree["blocks"][:1])
    with pytest.raises(ValueError, match="blocks"):
        params_from_jax(bad, config, device="cpu")


def test_rope_is_interleaved_like_jax():
    from tensorhive_tpu.models.transformer import _rope as jax_rope

    x = np.random.default_rng(1).standard_normal((2, 5, 3, 8), np.float32)
    positions = np.tile(np.arange(7, 12, dtype=np.int32), (2, 1))
    expected = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(positions),
                                   10_000.0))
    out = _rope(torch.from_numpy(x), torch.from_numpy(positions), 10_000.0)
    np.testing.assert_allclose(out.numpy(), expected, atol=1e-6, rtol=0)


def test_init_distributions_and_count():
    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32)
    generator = torch.Generator().manual_seed(0)
    params = TransformerLM.init(config, generator, device="cpu")
    assert abs(params["tok_embed"].std().item() - 0.02) < 2e-3
    wq = params["blocks"][0]["wq"]
    assert abs(wq.std().item() - config.d_model ** -0.5) < 0.02
    jax_params = JaxLM.init(jax.random.PRNGKey(0), dataclasses.replace(
        JAX_PRESETS["tiny"], dtype=jnp.float32))
    assert TransformerLM.param_count(params) == JaxLM.param_count(jax_params)
