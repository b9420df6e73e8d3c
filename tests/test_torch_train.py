"""The port's training path against the JAX package.

JAX-made f32 weights (``tiny`` preset, MHA and GQA) are carried into the
port as f32 masters (``params_from_jax(..., param_dtype=torch.float32)``).
On the same tokens:

* ``TransformerLM.loss`` and its gradients agree with ``jax.value_and_grad``
  of the JAX loss — full and chunked cross entropy, no remat and both remat
  policies — within 1e-5 (the loss) and 2e-5 (gradients): f32 on both
  sides, the two libraries' CPU matmuls sum in different orders.
* ``make_train_step`` agrees with the JAX ``make_train_step`` over 3 steps:
  loss and pre-clip ``grad_norm`` at every step within 1e-5 relative, and
  the params. Step 1 runs at learning rate 0 and leaves the params exactly
  as they were, on both sides. After that Adam divides each moment by its
  own root: an element whose gradient is at the rounding noise moves by up
  to a full learning rate on either side, whatever its sign. So each leaf
  is held on average — mean |difference| <= 1e-3 x the summed learning
  rates (a wrong optimizer moves the mean by a good fraction of them) —
  and no element may be off by more than 2 x the summed learning rates.

The JAX side runs its plain attention (``use_flash=False``); its own tests
pin the flash kernels to it, and ``test_torch_flash_backward.py`` pins the
port's backward to the kernels.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorhive_tpu import train as jax_train
from tensorhive_tpu.models import transformer as jax_transformer
from tensorhive_tpu.models.transformer import PRESETS as JAX_PRESETS
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu_torch import train
from tensorhive_tpu_torch.convert import params_from_jax, params_to_numpy
from tensorhive_tpu_torch.models import transformer
from tensorhive_tpu_torch.models.transformer import (
    PRESETS,
    TransformerLM,
    _lm_head,
    train_flops_per_token,
)

LOSS_TOL = 1e-5
GRAD_TOL = 2e-5


def configs(kv_heads=None, **knobs):
    jax_config = dataclasses.replace(
        JAX_PRESETS["tiny"], dtype=jnp.float32, use_flash=False,
        max_seq_len=64, n_kv_heads=kv_heads, **knobs)
    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                                 max_seq_len=64, n_kv_heads=kv_heads, **knobs)
    return jax_config, config


def jax_params(jax_config, seed=0):
    params = JaxLM.init(jax.random.PRNGKey(seed), jax_config)
    return params, jax.tree_util.tree_map(np.asarray, params)


def tokens_for(config, batch, length, seed=0):
    return np.random.default_rng(seed).integers(
        0, config.vocab_size, (batch, length + 1), dtype=np.int32)


def leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.fixture
def chunk_everything(monkeypatch):
    """Both losses take the chunked path whatever the logits' size."""
    monkeypatch.setattr(jax_transformer, "_chunk_threshold_bytes", lambda: 0)
    monkeypatch.setattr(transformer, "_chunk_threshold_bytes",
                        lambda device: 0)


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(chunk_tokens, seq, seed):
    """The JAX loss and gradients, once per case: remat does not change
    them, so the port's remat variants share one JAX reference."""
    jax_config, _ = configs(2, remat=False, loss_chunk_tokens=chunk_tokens)
    params, tree = jax_params(jax_config, seed=seed)
    tokens = tokens_for(jax_config, 2, seq, seed=seed)
    value, grads = jax.jit(jax.value_and_grad(JaxLM.loss), static_argnums=2)(
        params, jnp.asarray(tokens), jax_config)
    return tree, tokens, float(value), [np.asarray(g) for g in leaves(grads)]


def assert_loss_and_grads_match(config, chunk_tokens, seq, seed):
    tree, tokens, value, grads = jax_loss_and_grads(chunk_tokens, seq, seed)
    live = jax.tree_util.tree_map(
        lambda t: t.requires_grad_(),
        params_from_jax(tree, config, "cpu", param_dtype=torch.float32))
    loss = TransformerLM.loss(live, torch.from_numpy(tokens), config)
    ours = torch.autograd.grad(loss, train.tree_leaves(live))
    np.testing.assert_allclose(loss.item(), value, atol=LOSS_TOL, rtol=0)
    for got, want in zip(ours, grads):         # both in sorted-key order
        np.testing.assert_allclose(got.numpy(), want, atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


@pytest.mark.parametrize("remat,policy", [
    (False, "block"), (True, "block"), (True, "mlp")])
def test_loss_and_grads_match_jax(remat, policy):
    """Full cross entropy, GQA; the port with no remat and both policies
    against the JAX loss."""
    _, config = configs(2, remat=remat, remat_policy=policy,
                        loss_chunk_tokens=0)
    assert_loss_and_grads_match(config, 0, 32, 0)


@pytest.mark.parametrize("remat", [False, True])
def test_chunked_loss_matches_jax(chunk_everything, remat):
    """Chunked CE (n_tokens 2 x 40 = 80, chunk gcd(80, 48) = 16) through
    ``torch.utils.checkpoint`` per chunk against the JAX chunked loss."""
    _, config = configs(2, remat=remat, loss_chunk_tokens=48)
    assert transformer._loss_chunk(80, config, torch.device("cpu")) == 16
    assert_loss_and_grads_match(config, 48, 40, 1)


def assert_params_close(ours, theirs, lr_sum):
    """Per leaf on average: Adam moves an element whose gradient is at the
    rounding noise by up to a full learning rate either way, so no bound
    on the largest element could fail."""
    for got, want in zip(leaves(params_to_numpy(ours)), leaves(theirs)):
        diff = np.abs(got - np.asarray(want))
        assert diff.mean() <= 1e-3 * lr_sum, diff.mean()


@pytest.mark.parametrize("accum,max_norm,kv_heads", [
    (1, 1.0, None), (2, 1.0, 2), (1, 100.0, None)])
def test_train_steps_match_jax(accum, max_norm, kv_heads):
    """1 and 3 steps of make_train_step: clipping on (max_norm 1) and off
    (100), with and without 2 microbatches of gradient accumulation."""
    jax_config, config = configs(kv_heads, remat=False)
    knobs = dict(batch_size=4, seq_len=32, warmup_steps=1, total_steps=10,
                 learning_rate=1e-2, max_grad_norm=max_norm,
                 grad_accum_steps=accum)
    jax_tc = jax_train.TrainConfig(**knobs)
    tc = train.TrainConfig(**knobs)
    j_params, j_opt = jax_train.init_train_state(jax.random.PRNGKey(0),
                                                 jax_config, jax_tc)
    tree = jax.tree_util.tree_map(np.asarray, j_params)
    params = params_from_jax(tree, config, "cpu", param_dtype=torch.float32)
    opt_state = train.make_optimizer(tc).init(params)
    j_step = jax_train.make_train_step(jax_config, jax_tc)
    step = train.make_train_step(config, tc)
    tokens = tokens_for(config, 4, 32, seed=2)
    lr_sum = 0.0
    for index in range(3):
        j_params, j_opt, j_metrics = j_step(j_params, j_opt,
                                            jnp.asarray(tokens))
        params, opt_state, metrics = step(params, opt_state,
                                          torch.from_numpy(tokens))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(j_metrics[key]), rtol=1e-5)
        if index == 0:                  # lr 0: nothing moves, on both sides
            for got, start, want in zip(leaves(params_to_numpy(params)),
                                        leaves(tree), leaves(j_params)):
                assert np.array_equal(got, start)
                assert np.array_equal(got, np.asarray(want))
        lr_sum += train.make_optimizer(tc).learning_rate(index)
        assert_params_close(params, j_params, lr_sum)
    assert opt_state["count"] == 3


def test_schedule_matches_optax():
    """optax evaluates the schedule in f32: near the end of the cosine,
    1 + cos(..) loses ~1e-7 of the peak to cancellation there."""
    for warmup, total in ((0, 10), (3, 10), (100, 10_000)):
        schedule = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup,
                                                      total)
        for count in list(range(0, 12)) + [99, 100, 5000, 10_000, 20_000]:
            np.testing.assert_allclose(
                train.warmup_cosine_decay(count, 3e-4, warmup, total),
                float(schedule(count)), rtol=1e-6, atol=3e-4 * 1e-6)
    with pytest.raises(ValueError, match="total_steps"):
        train.make_optimizer(train.TrainConfig(warmup_steps=5, total_steps=5))


def test_train_flops_per_token_matches_jax():
    for name in ("t2t-base", "t2t-big", "7b"):
        for remat in (False, True):
            assert train_flops_per_token(PRESETS[name], 1024, remat) == \
                jax_transformer.train_flops_per_token(JAX_PRESETS[name], 1024,
                                                      remat)
    assert PRESETS["7b"].remat_policy == "mlp"
    assert PRESETS["t2t-big"].remat_policy == "block"


def test_serving_weights_serve_unchanged():
    """Weights stored in config.dtype (serving) give the logits that f32
    masters cast at use give, and the head rounds an f32 master to the
    compute dtype first, as the JAX head does."""
    _, tree = jax_params(configs()[0], seed=6)
    config = dataclasses.replace(PRESETS["tiny"], max_seq_len=64)   # bf16
    stored = params_from_jax(tree, config, "cpu")
    masters = params_from_jax(tree, config, "cpu", param_dtype=torch.float32)
    assert stored["blocks"][0]["wq"].dtype == torch.bfloat16
    assert masters["blocks"][0]["wq"].dtype == torch.float32
    tokens = torch.from_numpy(tokens_for(config, 2, 16)[:, :-1])
    with torch.no_grad():
        served = TransformerLM.apply(stored, tokens, config)
        cast = TransformerLM.apply(masters, tokens, config)
    assert torch.equal(served, cast)
    x = torch.randn(3, config.d_model)
    head = masters["w_lm_head"]
    assert torch.equal(_lm_head(x, head, torch.bfloat16),
                       _lm_head(x, head.to(torch.bfloat16), torch.bfloat16))
    assert not torch.equal(_lm_head(x, head, torch.bfloat16),
                           _lm_head(x, head, torch.float32))


def test_checkpoint_round_trip_and_retention(tmp_path):
    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32)
    tc = train.TrainConfig(batch_size=2, seq_len=8, warmup_steps=1,
                           total_steps=10)
    params, opt_state = train.init_train_state(
        config, tc, torch.Generator().manual_seed(3), device="cpu")
    step = train.make_train_step(config, tc)
    tokens = train.synthetic_batch(torch.Generator().manual_seed(4), tc,
                                   config.vocab_size, device="cpu")
    path = tmp_path / "ckpt"
    for index in range(1, 5):
        params, opt_state, _ = step(params, opt_state, tokens)
        train.save_checkpoint(str(path), index, params, opt_state,
                              max_to_keep=2)
    assert sorted(p.name for p in path.iterdir()) == [
        "step_0000000003.pt", "step_0000000004.pt"]
    fresh, fresh_opt = train.init_train_state(config, tc, device="cpu")
    restored_step, restored, restored_opt = train.restore_checkpoint(
        str(path), fresh, fresh_opt)
    assert restored_step == 4 and restored_opt["count"] == 4
    for got, want in zip(train.tree_leaves(restored),
                         train.tree_leaves(params)):
        assert torch.equal(got, want)
    for got, want in zip(train.tree_leaves(restored_opt["nu"]),
                         train.tree_leaves(opt_state["nu"])):
        assert torch.equal(got, want)
    with pytest.raises(FileNotFoundError):
        train.restore_checkpoint(str(tmp_path / "none"), fresh, fresh_opt)
    small = dataclasses.replace(config, d_model=32, n_heads=2)
    with pytest.raises(ValueError, match="template"):
        train.restore_checkpoint(str(path), *train.init_train_state(
            small, tc, device="cpu"))


def test_train_loop_on_the_cpu():
    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                                 n_layers=1)
    tc = train.TrainConfig(batch_size=2, seq_len=16, warmup_steps=1,
                           total_steps=7)
    metrics = train.train_loop(config, tc, num_steps=7, log_every=0,
                               sync_every=3, device="cpu")
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])
    assert metrics["steps_per_sec"] > 0 and metrics["rejected_windows"] >= 0
    assert train._steady_step_time([(9.0, True), (1.0, True), (1.2, True),
                                    (30.0, True), (0.5, False)]) == (1.2, 1)


def test_unported_and_invalid_options_are_refused():
    """A mesh is not yet ported; the LM loss refuses a bidirectional config
    and the model an unknown remat policy. (The CUDA default of the entry
    points is held in test_torch_package.py.)"""
    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32)
    tc = train.TrainConfig(batch_size=2, seq_len=8)
    for call in (lambda: train.make_train_step(config, tc, mesh=object()),
                 lambda: train.init_train_state(config, tc, device="cpu",
                                                mesh=object())):
        with pytest.raises(ValueError, match="not yet ported"):
            call()
    params = TransformerLM.init(config, device="cpu")
    tokens = torch.zeros((1, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="not yet ported"):
        TransformerLM.loss(params, tokens, config, mesh=object())
    with pytest.raises(ValueError, match="causal"):
        TransformerLM.loss(params, tokens,
                           dataclasses.replace(config, causal=False))
    with pytest.raises(ValueError, match="remat_policy"):
        TransformerLM.apply(params, tokens, dataclasses.replace(
            config, remat_policy="attention"))
