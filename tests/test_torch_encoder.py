"""The port's MLM encoder family against the JAX package.

JAX-made f32 weights of the ``tiny`` encoder are carried into the port as
f32 masters; on the same numpy-made (inputs, targets, mask):

* ``mlm_loss`` and its gradients agree with ``jax.value_and_grad`` of the
  JAX ``mlm_loss`` within 1e-5 relative (f32 both sides; the libraries' CPU
  matmuls sum in different orders), on the full-logits and the chunked path;
  the weighted ``_chunked_ce`` agrees with the JAX one.
* A ``make_train_step`` on packed [B, 3, L] batches with two microbatches
  agrees with the JAX step over 3 steps (loss and grad_norm within 1e-5
  relative, params per leaf on average, as ``test_torch_train.py``).
* ``decode.evaluate`` agrees with the JAX ``decode.evaluate`` on a causal
  config and refuses an encoder; ``generate`` refuses an encoder too.

The masking recipe draws from a ``torch.Generator``, so it is held to its
fractions and its determinism, not to JAX's draws.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu import train as jax_train
from tensorhive_tpu.models import decode as jax_decode
from tensorhive_tpu.models import encoder as jax_encoder
from tensorhive_tpu.models import transformer as jax_transformer
from tensorhive_tpu.models.transformer import PRESETS as JAX_PRESETS
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu_torch import train
from tensorhive_tpu_torch.convert import params_from_jax, params_to_numpy
from tensorhive_tpu_torch.models import decode, encoder, transformer
from tensorhive_tpu_torch.models.encoder import ENCODER_PRESETS
from tensorhive_tpu_torch.models.transformer import PRESETS, TransformerLM

REL_TOL = 1e-5


def configs(causal=False, **knobs):
    jax_config = dataclasses.replace(
        JAX_PRESETS["tiny"], dtype=jnp.float32, use_flash=False, remat=False,
        max_seq_len=64, causal=causal, **knobs)
    config = dataclasses.replace(
        ENCODER_PRESETS["tiny"], dtype=torch.float32, remat=False,
        max_seq_len=64, causal=causal, flash_bh_block=4, **knobs)
    return jax_config, config


def jax_params(jax_config, seed=0):
    params = JaxLM.init(jax.random.PRNGKey(seed), jax_config)
    return params, jax.tree_util.tree_map(np.asarray, params)


def masked_batch(config, batch, length, seed):
    """(inputs, targets, mask) from numpy: about 15% of positions selected,
    most of them replaced by [MASK]."""
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, config.vocab_size - 1, (batch, length),
                           dtype=np.int32)
    mask = rng.random((batch, length)) < 0.15
    mask[:, 0] = True                         # never an empty mask
    inputs = np.where(mask & (rng.random((batch, length)) < 0.8),
                      config.vocab_size - 1, targets).astype(np.int32)
    return inputs, targets, mask


@pytest.fixture
def chunk_everything(monkeypatch):
    monkeypatch.setattr(jax_transformer, "_chunk_threshold_bytes", lambda: 0)
    monkeypatch.setattr(transformer, "_chunk_threshold_bytes",
                        lambda device: 0)


def test_presets_and_mask_token():
    for name, config in ENCODER_PRESETS.items():
        assert not config.causal
        assert dataclasses.replace(config, causal=True) == PRESETS[name]
        assert encoder.mask_token_id(config) == config.vocab_size - 1
    assert set(ENCODER_PRESETS) == set(jax_encoder.ENCODER_PRESETS)


def test_mask_recipe_fractions_and_determinism():
    config = ENCODER_PRESETS["tiny"]
    tokens = torch.full((64, 512), 7, dtype=torch.int32)
    inputs, targets, mask = encoder.mask_tokens(
        torch.Generator().manual_seed(0), tokens, config)
    n = tokens.numel()
    selected = mask.sum().item()
    assert abs(selected / n - 0.15) < 4 * (0.15 * 0.85 / n) ** 0.5
    assert torch.equal(targets, tokens)
    assert torch.equal(inputs[~mask], tokens[~mask])   # unselected: as-is
    chosen = inputs[mask]
    as_mask = (chosen == encoder.mask_token_id(config)).sum().item()
    kept = (chosen == 7).sum().item()
    randomized = selected - as_mask - kept
    # binomial shares of the selected positions, 4 sigma; a random token
    # equal to the original (1/512 of them) counts as kept
    for count, p in ((as_mask, 0.8), (randomized, 0.1 * 511 / 512),
                     (kept, 0.1 + 0.1 / 512)):
        assert abs(count / selected - p) < 4 * (p * (1 - p) / selected) ** 0.5
    again = encoder.mask_tokens(torch.Generator().manual_seed(0), tokens,
                                config)
    other = encoder.mask_tokens(torch.Generator().manual_seed(1), tokens,
                                config)
    assert all(torch.equal(a, b) for a, b in zip(again, (inputs, targets,
                                                         mask)))
    assert not torch.equal(other[2], mask)
    packed = encoder.pack_mlm_batch(torch.Generator().manual_seed(0), tokens,
                                    config)
    assert packed.shape == (64, 3, 512) and packed.dtype == torch.int32
    assert torch.equal(packed[:, 0], inputs)
    assert torch.equal(packed[:, 2].bool(), mask)


def assert_mlm_loss_and_grads_match(config, jax_config, seed):
    params, tree = jax_params(jax_config, seed=seed)
    inputs, targets, mask = masked_batch(config, 2, 40, seed)
    value, grads = jax.jit(jax.value_and_grad(jax_encoder.mlm_loss),
                           static_argnums=4)(
        params, jnp.asarray(inputs), jnp.asarray(targets), jnp.asarray(mask),
        jax_config)
    live = train.tree_map(
        lambda t: t.requires_grad_(),
        params_from_jax(tree, config, "cpu", param_dtype=torch.float32))
    loss = encoder.mlm_loss(live, torch.from_numpy(inputs),
                            torch.from_numpy(targets), torch.from_numpy(mask),
                            config)
    ours = torch.autograd.grad(loss, train.tree_leaves(live))
    np.testing.assert_allclose(loss.item(), float(value), rtol=REL_TOL)
    for got, want in zip(ours, jax.tree_util.tree_leaves(grads)):
        scale = np.abs(np.asarray(want)).max()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=REL_TOL * scale, rtol=REL_TOL)
    return loss.item()


def test_mlm_loss_and_grads_match_jax():
    jax_config, config = configs(loss_chunk_tokens=0)
    assert_mlm_loss_and_grads_match(config, jax_config, 0)


def test_chunked_mlm_loss_matches_jax_and_the_full_path(chunk_everything):
    """n_tokens 2 x 40 = 80, chunk gcd(80, 48) = 16, the mask as weights."""
    jax_config, config = configs(loss_chunk_tokens=48)
    assert transformer._loss_chunk(80, config, torch.device("cpu")) == 16
    chunked = assert_mlm_loss_and_grads_match(config, jax_config, 1)
    _, tree = jax_params(jax_config, seed=1)
    params = params_from_jax(tree, config, "cpu", param_dtype=torch.float32)
    batch = [torch.from_numpy(a) for a in masked_batch(config, 2, 40, 1)]
    full = encoder.mlm_loss(params, *batch, dataclasses.replace(
        config, loss_chunk_tokens=0))
    np.testing.assert_allclose(chunked, full.item(), rtol=REL_TOL)


def test_weighted_chunked_ce_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((48, 16), np.float32)
    w_head = rng.standard_normal((16, 40), np.float32)
    targets = rng.integers(0, 40, 48, dtype=np.int32)
    weights = (rng.random(48) < 0.3)
    for given in (None, weights):
        theirs = jax_transformer._chunked_ce(
            jnp.asarray(x), jnp.asarray(targets), jnp.asarray(w_head),
            jnp.float32, 16,
            weights_flat=None if given is None else jnp.asarray(given))
        ours = transformer._chunked_ce(
            torch.from_numpy(x), torch.from_numpy(targets),
            torch.from_numpy(w_head), torch.float32, 16,
            weights_flat=None if given is None else torch.from_numpy(given))
        np.testing.assert_allclose(ours.item(), float(theirs), rtol=REL_TOL)


def test_encoder_sees_future_context():
    """Bidirectional attention: changing the last token moves the logits
    of the first position; under the causal config it does not."""
    _, config = configs()
    params = TransformerLM.init(config, torch.Generator().manual_seed(2),
                                device="cpu")
    tokens = torch.randint(0, 500, (1, 12), generator=torch.Generator()
                           .manual_seed(3))
    changed = tokens.clone()
    changed[0, -1] = (changed[0, -1] + 1) % 500
    for causal in (False, True):
        cfg = dataclasses.replace(config, causal=causal)
        with torch.no_grad():
            a = TransformerLM.apply(params, tokens, cfg)[0, 0]
            b = TransformerLM.apply(params, changed, cfg)[0, 0]
        assert torch.equal(a, b) == causal


def test_generate_and_evaluate_refuse_encoders():
    _, config = configs()
    params = TransformerLM.init(config, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        decode.generate(params, config, [[1, 2]], 2, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        decode.evaluate(params, config, iter([]), 1)


def test_evaluate_matches_jax():
    """The port's ``decode.evaluate`` (added here) against the JAX one on a
    causal config, two [B, L+1] batches; then its guards."""
    jax_config, config = configs(causal=True)
    params, tree = jax_params(jax_config, seed=5)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, config.vocab_size, (2, 17), dtype=np.int32)
               for _ in range(2)]
    theirs = jax_decode.evaluate(params, jax_config,
                                 iter(jnp.asarray(b) for b in batches), 2)
    ours = decode.evaluate(
        params_from_jax(tree, config, "cpu", param_dtype=torch.float32),
        config, iter(torch.from_numpy(b) for b in batches), 2)
    assert ours["batches"] == theirs["batches"] == 2
    for key in ("loss", "perplexity"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=REL_TOL)
    ported = params_from_jax(tree, config, "cpu")
    with pytest.raises(ValueError, match="exhausted at batch 1"):
        decode.evaluate(ported, config, iter([torch.from_numpy(batches[0])]),
                        2)
    with pytest.raises(ValueError, match="num_batches"):
        decode.evaluate(ported, config, iter([]), 0)


def test_mlm_evaluate_guards_and_determinism():
    _, config = configs()
    params = TransformerLM.init(config, torch.Generator().manual_seed(6),
                                device="cpu")
    rng = np.random.default_rng(6)
    batches = [torch.from_numpy(rng.integers(0, 400, (2, 24),
                                             dtype=np.int32))
               for _ in range(3)]
    first = encoder.mlm_evaluate(params, config, iter(batches), 3, seed=4)
    again = encoder.mlm_evaluate(params, config, iter(batches), 3, seed=4)
    assert first == again and first["batches"] == 3
    assert np.isfinite(first["loss"])
    np.testing.assert_allclose(first["pseudo_perplexity"],
                               np.exp(first["loss"]), rtol=1e-12)
    with pytest.raises(ValueError, match="causal=False"):
        encoder.mlm_evaluate(params, dataclasses.replace(config, causal=True),
                             iter(batches), 1)
    with pytest.raises(ValueError, match="num_batches"):
        encoder.mlm_evaluate(params, config, iter(batches), 0)
    with pytest.raises(ValueError, match="exhausted at batch 3"):
        encoder.mlm_evaluate(params, config, iter(batches), 4)
    with pytest.raises(ValueError, match="causal=False"):
        encoder.init_encoder(dataclasses.replace(config, causal=True),
                             device="cpu")
    made, made_config = encoder.init_encoder(preset="tiny", device="cpu")
    assert made_config == ENCODER_PRESETS["tiny"]
    assert made["tok_embed"].shape == (512, 64)


def test_packed_train_steps_with_accumulation_match_jax():
    """Two microbatches of a packed [4, 3, L] MLM batch: each microbatch
    keeps its sequences' inputs, targets and mask together (splitting the
    flattened rows would mix them)."""
    jax_config, config = configs(loss_chunk_tokens=0)
    knobs = dict(batch_size=4, seq_len=24, warmup_steps=1, total_steps=10,
                 learning_rate=1e-2, grad_accum_steps=2)
    jax_tc = jax_train.TrainConfig(**knobs)
    tc = train.TrainConfig(**knobs)
    j_params, j_opt = jax_train.init_train_state(jax.random.PRNGKey(0),
                                                 jax_config, jax_tc)
    tree = jax.tree_util.tree_map(np.asarray, j_params)
    params = params_from_jax(tree, config, "cpu", param_dtype=torch.float32)
    opt_state = train.make_optimizer(tc).init(params)
    j_step = jax_train.make_train_step(jax_config, jax_tc,
                                       loss_fn=jax_encoder.mlm_loss_packed)
    step = train.make_train_step(config, tc, loss_fn=encoder.mlm_loss_packed)
    inputs, targets, mask = masked_batch(config, 4, 24, 7)
    packed = np.stack([inputs, targets, mask.astype(np.int32)], axis=1)
    lr_sum = 0.0
    for index in range(3):
        j_params, j_opt, j_metrics = j_step(j_params, j_opt,
                                            jnp.asarray(packed))
        params, opt_state, metrics = step(params, opt_state,
                                          torch.from_numpy(packed))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(j_metrics[key]), rtol=REL_TOL)
        lr_sum += train.make_optimizer(tc).learning_rate(index)
        for got, want in zip(jax.tree_util.tree_leaves(params_to_numpy(params)),
                             jax.tree_util.tree_leaves(j_params)):
            assert np.abs(got - np.asarray(want)).mean() <= 1e-3 * lr_sum
