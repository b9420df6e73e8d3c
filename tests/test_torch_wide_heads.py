"""The port's slice at a head width and GQA group past the kernels' first
set, against the JAX package: d_head 80 over groups of 3 (``tiny`` at
d_model 480, 6 heads over 2 KV heads, 2 layers, f32), the shape class of
Phi-2's heads (d_head 80) and Qwen2.5-7B's groups (7).

* A ``SlotEngine`` on JAX-made weights serves staggered requests with the
  same greedy tokens as the JAX engine (whole-prompt prefill, paged, on f32
  pages and on int8 pages), as ``test_torch_serving.py`` holds the
  ``tiny`` engines.
* ``TransformerLM.loss`` and its gradients agree with ``jax.value_and_grad``
  of the JAX loss within ``test_torch_train.py``'s bounds (1e-5 the loss,
  2e-5 the gradients), and one ``make_train_step`` step's loss and
  pre-clip grad norm with the JAX step's within 1e-5 relative.

On the CPU the port runs its kernels' plain versions; the kernels at these
shapes run on the card (``chip_smoke.py``'s phase ``shapes``,
``tests/test_torch_cuda_kernels.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu import train as jax_train
from tensorhive_tpu.models.transformer import PRESETS as JAX_PRESETS
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu.serving.engine import SlotEngine as JaxSlotEngine
from tensorhive_tpu_torch import train
from tensorhive_tpu_torch.convert import params_from_jax
from tensorhive_tpu_torch.models.transformer import PRESETS, TransformerLM
from tensorhive_tpu_torch.serving.engine import SlotEngine

LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
WIDE = {"d_model": 480, "n_heads": 6, "n_kv_heads": 2, "d_ff": 1280,
        "n_layers": 2, "max_seq_len": 128}


def configs(**knobs):
    jax_config = dataclasses.replace(JAX_PRESETS["tiny"], dtype=jnp.float32,
                                     use_flash=False, **WIDE, **knobs)
    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                                 **WIDE, **knobs)
    assert config.d_head == 80 and config.n_heads // config.kv_heads == 3
    return jax_config, config


def greedy_schedule(engine):
    """Three staggered joins (one of a single token) and a follow-up that
    reuses freed pages; each request's (outcome, tokens)."""
    prompts = [list(range(3, 20)), [7], list(range(30, 70)), [9, 8, 7, 6]]
    handles = []
    for prompt, new in zip(prompts[:3], (8, 6, 10)):
        handles.append(engine.submit(prompt, max_new_tokens=new))
        engine.step()
    while engine.has_work():
        engine.step()
    handles.append(engine.submit(prompts[3], max_new_tokens=5))
    while engine.has_work():
        engine.step()
    return [(s["outcome"], s["tokens"])
            for s in (h.result(timeout_s=5) for h in handles)]


@pytest.mark.parametrize("kv_quant", ["off", "on"])
def test_engine_at_d80_group3_matches_jax_engine(kv_quant):
    jax_config, config = configs(remat=False)
    jax_params = JaxLM.init(jax.random.PRNGKey(1), jax_config)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                             config, device="cpu")
    engine_args = dict(slots=2, max_len=96, queue_depth=8, page_size=16,
                       kv_quant=kv_quant, prefix_cache="off",
                       speculative="off")
    expected = greedy_schedule(JaxSlotEngine(
        jax_params, jax_config, paged_kernel="off", **engine_args))
    engine = SlotEngine(params, config, device="cpu", **engine_args)
    assert greedy_schedule(engine) == expected
    assert [outcome for outcome, _ in expected] == ["completed"] * 4
    stats = engine.stats()
    assert stats["kvPagesFree"] == stats["kvPagesTotal"]


def test_loss_grads_and_train_step_at_d80_group3_match_jax():
    jax_config, config = configs(remat=True, remat_policy="block")
    jax_params = JaxLM.init(jax.random.PRNGKey(2), jax_config)
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    tokens = np.random.default_rng(2).integers(
        0, config.vocab_size, (2, 97), dtype=np.int32)
    value, jax_grads = jax.value_and_grad(JaxLM.loss)(
        jax_params, jnp.asarray(tokens), jax_config)
    live = jax.tree_util.tree_map(
        lambda t: t.requires_grad_(),
        params_from_jax(tree, config, "cpu", param_dtype=torch.float32))
    loss = TransformerLM.loss(live, torch.from_numpy(tokens), config)
    grads = torch.autograd.grad(loss, train.tree_leaves(live))
    np.testing.assert_allclose(loss.item(), float(value), atol=LOSS_TOL,
                               rtol=0)
    for got, want in zip(grads, jax.tree_util.tree_leaves(jax_grads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)

    # one step of make_train_step on both sides: loss and pre-clip norm
    knobs = dict(batch_size=2, seq_len=96, warmup_steps=1, total_steps=10,
                 learning_rate=1e-3)
    jax_tc = jax_train.TrainConfig(**knobs)
    tc = train.TrainConfig(**knobs)
    jax_opt = jax_train.make_optimizer(jax_tc).init(jax_params)
    _, _, jax_metrics = jax_train.make_train_step(jax_config, jax_tc)(
        jax_params, jax_opt, jnp.asarray(tokens))
    params = params_from_jax(tree, config, "cpu", param_dtype=torch.float32)
    _, _, metrics = train.make_train_step(config, tc)(
        params, train.make_optimizer(tc).init(params),
        torch.from_numpy(tokens))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(jax_metrics[key]), rtol=1e-5)
