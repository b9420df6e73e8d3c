"""The port's ``generate`` against JAX ``decode.generate``: identical greedy
tokens on the same JAX-made f32 weights, for a 1-token prompt (no
prefill), a bucket-padded prompt (5-token head padded to the 16 bucket)
and a longer one, MHA and GQA. Sampling is checked by its contract
(top-k=1 is greedy; a seed reproduces its draw)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu.models import decode as jax_decode
from tensorhive_tpu.models.transformer import PRESETS as JAX_PRESETS
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu_torch.convert import params_from_jax
from tensorhive_tpu_torch.models import decode
from tensorhive_tpu_torch.models.transformer import PRESETS


def setup(kv_heads):
    jax_config = dataclasses.replace(
        JAX_PRESETS["tiny"], dtype=jnp.float32, use_flash=False, remat=False,
        max_seq_len=128, n_kv_heads=kv_heads)
    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                                 max_seq_len=128, n_kv_heads=kv_heads)
    jax_params = JaxLM.init(jax.random.PRNGKey(1), jax_config)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                             config, device="cpu")
    return jax_config, config, jax_params, params


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_greedy_tokens_match_jax(kv_heads):
    jax_config, config, jax_params, params = setup(kv_heads)
    prompts = [[7], [3, 1, 4, 1, 5, 9], list(range(10, 40))]
    for prompt in prompts:
        expected = np.asarray(jax_decode.generate(
            jax_params, jax_config, jnp.asarray([prompt, prompt[::-1]],
                                                jnp.int32),
            max_new_tokens=8))
        out = decode.generate(params, config, [prompt, prompt[::-1]],
                              max_new_tokens=8, device="cpu")
        assert out.dtype == torch.int32 and out.shape == expected.shape
        assert out.tolist() == expected.tolist()


def test_sampling_contract():
    _, config, _, params = setup(2)
    prompt = [[5, 6, 7]]
    greedy = decode.generate(params, config, prompt, 6, device="cpu")
    top1 = decode.generate(params, config, prompt, 6, temperature=0.9,
                           top_k=1, seed=4, device="cpu")
    assert top1.tolist() == greedy.tolist()
    first = decode.generate(params, config, prompt, 6, temperature=1.0,
                            seed=11, device="cpu")
    again = decode.generate(params, config, prompt, 6, temperature=1.0,
                            seed=11, device="cpu")
    assert first.tolist() == again.tolist()
    with pytest.raises(ValueError, match="top_k"):
        decode.generate(params, config, prompt, 4, temperature=1.0,
                        top_k=0, device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        decode.generate(params, config, prompt, 200, device="cpu")


def test_bucket_rule_matches_jax():
    for length in (1, 5, 15, 16, 17, 299, 2999, 4095):
        for cap in (4095, 96, 2000):
            assert (decode._prefill_bucket(length, cap)
                    == jax_decode._prefill_bucket(length, cap))
    assert decode._prefill_bucket(2999, 4095) == 4095
