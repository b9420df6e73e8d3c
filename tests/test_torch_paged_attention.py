"""The port's paged decode attention against the JAX kernel.

The same query, pages, page table and positions, drawn from a numpy seed,
go through the JAX ``paged_attention`` kernel (interpret mode, as
``tests/unit/test_paged_attention.py`` runs it) and through the port's
``paged_attention`` on CPU tensors — the plain page gather the CUDA kernel
is held to. Tables hold trash entries past each slot's window, positions
sit at 0 (a parked slot on the trash page), at page boundaries and at the
last position; pages are f32 or int8 with per-(page, kv_head) scales. The
outputs agree within 1e-6 abs (accumulation order only; the JAX tests
accept ~1e-7 between its kernel and its gather). The port's plain version
(``paged_attention_reference``) is held to the JAX gather too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu.models import decode as jax_decode
from tensorhive_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
)
from tensorhive_tpu_torch.ops import paged_attention as paged_module
from tensorhive_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_reference,
    resolve_paged_kernel,
)

TOL = 1e-6


def paged_case(seed, *, heads, kv_heads, page_size, quant, d_head=16):
    """4 slots over 12 physical pages (page 0 = trash), 4 pages per row."""
    rng = np.random.default_rng(seed)
    num_pages, max_pages = 12, 4
    q = rng.standard_normal((4, 1, heads, d_head), np.float32)
    shape = (num_pages, page_size, kv_heads, d_head)
    if quant:
        k_pages = rng.integers(-127, 128, shape).astype(np.int8)
        v_pages = rng.integers(-127, 128, shape).astype(np.int8)
        k_scales = rng.uniform(0.005, 0.02, (num_pages, kv_heads)
                               ).astype(np.float32)
        v_scales = rng.uniform(0.005, 0.02, (num_pages, kv_heads)
                               ).astype(np.float32)
    else:
        k_pages = rng.standard_normal(shape, np.float32)
        v_pages = rng.standard_normal(shape, np.float32)
        k_scales = v_scales = None
    page_table = np.array([[3, 7, 1, 9],       # full window
                           [5, 2, 0, 0],       # trash past the window
                           [0, 0, 0, 0],       # parked slot
                           [11, 4, 8, 0]], np.int32)
    positions = np.array([4 * page_size - 1, page_size, 0, 2 * page_size - 1],
                         np.int32)
    return q, k_pages, v_pages, page_table, positions, k_scales, v_scales


def as_jax(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def as_torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("kv_heads,heads,page_size", [(4, 4, 8), (2, 4, 16)])
def test_plain_version_matches_jax_kernel(quant, kv_heads, heads, page_size):
    case = paged_case(page_size + kv_heads, heads=heads, kv_heads=kv_heads,
                      page_size=page_size, quant=quant)
    q, k, v, table, positions, k_scales, v_scales = as_jax(case)
    expected = np.asarray(jax_paged_attention(
        q, k, v, table, positions, interpret=True, k_scales=k_scales,
        v_scales=v_scales))
    before = dict(paged_module.launches)
    tq, tk, tv, ttable, tpos, tks, tvs = as_torch(case)
    out = paged_attention(tq, tk, tv, ttable, tpos, k_scales=tks,
                          v_scales=tvs)
    assert paged_module.launches == before      # CPU: no kernel launch
    assert out.shape == tq.shape and out.dtype == torch.float32
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), expected, atol=TOL, rtol=0)
    # the plain version against the JAX gather dispatch
    gather = paged_attention_reference(tq, tk, tv, ttable, tpos,
                                       k_scales=tks, v_scales=tvs)
    jax_gather = jax_decode._paged_attend(q, k, v, table, positions,
                                          use_kernel=False, k_scales=k_scales,
                                          v_scales=v_scales)
    np.testing.assert_allclose(gather.numpy(), np.asarray(jax_gather),
                               atol=TOL, rtol=0)


def test_resolve_paged_kernel_knob():
    assert resolve_paged_kernel("on") == "cuda"
    assert resolve_paged_kernel("auto") == "cuda"
    # the plain gather as an operator choice would run it on the card
    with pytest.raises(ValueError, match="paged_kernel='off'"):
        resolve_paged_kernel("off")
    with pytest.raises(ValueError, match="paged_kernel"):
        resolve_paged_kernel("pallas")
