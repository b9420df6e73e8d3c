"""The port's int8 KV-page quantizer against the JAX one, bytewise, and
its quality probe ``sim_kv_loss`` against JAX's.

``step_write``, ``row_merge`` and ``dequant_gather`` get the same pages,
scales and values (numpy seed) on both sides; the int8 payloads and the
f32 scales they write must be byte-identical, including offset-0 rebases,
dropped (out-of-range or invalid) writes, and writes to the trash page.
The port's ``step_write`` takes in-range page ids only; the JAX function
drops an out-of-range one, so the port is given the same writes without it.

``sim_kv_loss`` on JAX-made f32 tiny weights (GQA, a last page cut short)
is held to JAX's within 1e-5 relative unquantized and 1e-4 quantized, and
its per-page round trip (``page_requant``) is byte-identical to the one
JAX's probe applies, on the K and V JAX's first layer attends with.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu.models.transformer import PRESETS as JAX_PRESETS
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu.ops import kv_quant as jax_kvq
from tensorhive_tpu_torch.convert import params_from_jax
from tensorhive_tpu_torch.models.transformer import PRESETS
from tensorhive_tpu_torch.ops import kv_quant as kvq

# the module (``tensorhive_tpu.ops`` exports a function of the same name)
jax_flash = importlib.import_module("tensorhive_tpu.ops.flash_attention")

P, PS, HKV, DH = 10, 4, 2, 8


def pool(seed):
    rng = np.random.default_rng(seed)
    pages = rng.integers(-127, 128, (P, PS, HKV, DH)).astype(np.int8)
    scales = rng.uniform(0.01, 0.05, (P, HKV)).astype(np.float32)
    return rng, pages, scales


def assert_bytes_equal(ours, theirs):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    assert np.array_equal(ours.view(np.uint8), theirs.view(np.uint8))


def test_step_write_is_byte_identical():
    rng, pages, scales = pool(0)
    # slot 0: trash page, offset 0; slot 1: mid-page (a value large enough
    # to grow the scale); slot 2: offset 0 of a recycled page (rebase);
    # slot 3: out of range (dropped); slot 4: small values, no rescale
    page_ids = np.array([0, 3, 5, P + 2, 7], np.int32)
    offsets = np.array([0, 2, 0, 1, 3], np.int32)
    values = rng.standard_normal((5, HKV, DH)).astype(np.float32)
    values[1] *= 40.0
    values[4] *= 1e-3
    jax_pages, jax_scales = jax_kvq.step_write(
        jnp.asarray(pages), jnp.asarray(scales), jnp.asarray(page_ids),
        jnp.asarray(offsets), jnp.asarray(values))
    ours = torch.from_numpy(pages.copy())
    our_scales = torch.from_numpy(scales.copy())
    kept = (page_ids >= 0) & (page_ids < P)     # JAX's mode="drop"
    out_pages, out_scales = kvq.step_write(
        ours, our_scales, torch.from_numpy(page_ids[kept]),
        torch.from_numpy(offsets[kept]), torch.from_numpy(values[kept]))
    assert out_pages is ours and out_scales is our_scales   # in place
    assert_bytes_equal(ours.numpy(), jax_pages)
    assert_bytes_equal(our_scales.numpy(), jax_scales)
    untouched = [p for p in range(P) if p not in (0, 3, 5, 7)]
    assert np.array_equal(ours.numpy()[untouched], pages[untouched])


@pytest.mark.parametrize("start", [0, 2, 5])
def test_row_merge_is_byte_identical(start):
    """A window of positions through two rows; padding and cells past the
    row are invalid and must write nothing; ``start`` 0 and 4 hit
    offset-0 rebases, 2 and 5 start mid-page."""
    rng, pages, scales = pool(start + 1)
    rows = np.array([[4, 8, 2, 0], [6, 1, 9, 0]], np.int32)
    width = 9
    logical = np.tile(np.arange(start, start + width, dtype=np.int32), (2, 1))
    valid = np.ones((2, width), bool)
    valid[0, 6:] = False                        # padding of row 0
    valid[1] &= logical[1] < 12                 # row 1 stops at its 3rd page
    values = (rng.standard_normal((2, width, HKV, DH)) * 3).astype(np.float32)
    jax_pages, jax_scales, jax_ctx = jax_kvq.row_merge(
        jnp.asarray(pages), jnp.asarray(scales), jnp.asarray(rows),
        jnp.asarray(values), jnp.asarray(logical), jnp.asarray(valid),
        jnp.float32)
    ours = torch.from_numpy(pages.copy())
    our_scales = torch.from_numpy(scales.copy())
    _, _, ctx = kvq.row_merge(ours, our_scales, torch.from_numpy(rows),
                              torch.from_numpy(values),
                              torch.from_numpy(logical),
                              torch.from_numpy(valid), torch.float32)
    assert_bytes_equal(ours.numpy(), jax_pages)
    assert_bytes_equal(our_scales.numpy(), jax_scales)
    assert_bytes_equal(ctx.numpy(), jax_ctx)
    # the trash page (0) sits in both rows past the window: never written
    assert np.array_equal(ours.numpy()[0], pages[0])


def test_dequant_gather_matches():
    _, pages, scales = pool(9)
    table = np.array([[3, 0, 1], [9, 9, 2]], np.int32)
    expected = jax_kvq.dequant_gather(jnp.asarray(pages), jnp.asarray(scales),
                                      jnp.asarray(table), jnp.float32)
    out = kvq.dequant_gather(torch.from_numpy(pages),
                             torch.from_numpy(scales),
                             torch.from_numpy(table), torch.float32)
    assert_bytes_equal(out.numpy(), expected)


def test_knobs_and_byte_accounting():
    assert kvq.resolve_kv_quant("auto", paged=True) == "on"
    assert kvq.resolve_kv_quant("off", paged=True) == "off"
    assert kvq.resolve_kv_quant("auto", paged=False) == "off"
    with pytest.raises(ValueError):
        kvq.resolve_kv_quant("on", paged=False)
    with pytest.raises(ValueError):
        kvq.resolve_kv_quant("maybe", paged=True)
    for args in [(16, 8, 128), (16, 2, 16)]:
        assert kvq.quant_page_bytes(*args) == jax_kvq.quant_page_bytes(*args)
        assert kvq.page_bytes(*args, 2) == jax_kvq.page_bytes(*args, 2)


PAGE = 16


@pytest.fixture(scope="module")
def probe_setup():
    """JAX's f32 tiny model with GQA (4 heads over 2 KV heads), the port's
    copy of its weights, and [2, 41] tokens (40 inputs: the last page holds
    8 positions)."""
    jax_config = dataclasses.replace(JAX_PRESETS["tiny"], dtype=jnp.float32,
                                     n_kv_heads=2)
    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                                 n_kv_heads=2)
    jax_params = JaxLM.init(jax.random.PRNGKey(3), jax_config)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                             config, "cpu", param_dtype=torch.float32)
    tokens = np.random.default_rng(4).integers(
        0, config.vocab_size, (2, 41), dtype=np.int32)
    return jax_config, config, jax_params, params, tokens


@pytest.mark.parametrize("quantized,tol", [(False, 1e-5), (True, 1e-4)])
def test_sim_kv_loss_matches_jax(probe_setup, quantized, tol):
    jax_config, config, jax_params, params, tokens = probe_setup
    theirs = float(jax_kvq.sim_kv_loss(jax_params, jax_config,
                                       jnp.asarray(tokens), PAGE,
                                       quantized=quantized))
    with torch.no_grad():
        ours = kvq.sim_kv_loss(params, config, torch.from_numpy(tokens),
                               PAGE, quantized=quantized)
    assert ours.dtype == torch.float32 and ours.dim() == 0
    np.testing.assert_allclose(float(ours), theirs, rtol=tol, atol=0)


def test_page_requant_is_byte_identical(probe_setup, monkeypatch):
    """The K and V JAX's first layer attends with, unquantized and after
    its round trip (caught at its ``reference_attention``), against the
    port's ``page_requant`` of the same unquantized values; the probe's
    delta stays under JAX's 2% gate."""
    jax_config, config, jax_params, _, tokens = probe_setup
    seen = []
    real = jax_flash.reference_attention

    def spy(q, k, v, **kwargs):
        seen.append((np.array(k), np.array(v)))
        return real(q, k, v, **kwargs)

    monkeypatch.setattr(jax_flash, "reference_attention", spy)
    losses = [float(jax_kvq.sim_kv_loss(jax_params, jax_config,
                                        jnp.asarray(tokens), PAGE,
                                        quantized=quantized))
              for quantized in (False, True)]
    layers = jax_config.n_layers
    assert len(seen) == 2 * layers
    (raw_k, raw_v), (jax_k, jax_v) = seen[0], seen[layers]
    assert not np.array_equal(raw_k, jax_k)
    for raw, theirs in ((raw_k, jax_k), (raw_v, jax_v)):
        ours = kvq.page_requant(torch.from_numpy(raw), PAGE).numpy()
        assert_bytes_equal(ours, theirs)
    assert abs(losses[1] - losses[0]) / losses[0] < 0.02
