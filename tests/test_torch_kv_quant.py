"""The port's int8 KV-page quantizer against the JAX one, bytewise.

``step_write``, ``row_merge`` and ``dequant_gather`` get the same pages,
scales and values (numpy seed) on both sides; the int8 payloads and the
f32 scales they write must be byte-identical, including offset-0 rebases,
dropped (out-of-range or invalid) writes, and writes to the trash page.
The port's ``step_write`` takes in-range page ids only; the JAX function
drops an out-of-range one, so the port is given the same writes without it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu.ops import kv_quant as jax_kvq
from tensorhive_tpu_torch.ops import kv_quant as kvq

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
