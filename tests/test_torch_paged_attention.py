"""The port's paged decode attention against the JAX kernel.

The same query, pages, page table and positions, drawn from a numpy seed,
go through the JAX ``paged_attention`` kernel (interpret mode, as
``tests/unit/test_paged_attention.py`` runs it) and through the port's
``paged_attention`` on CPU tensors — the plain page gather the CUDA kernel
is held to. Tables hold trash entries past each slot's window, positions
sit at 0 (a parked slot on the trash page), at page boundaries and at the
last position; pages are f32 or int8 with per-(page, kv_head) scales. The
outputs agree within 1e-6 abs at d_head 16 (accumulation order only; the
JAX tests accept ~1e-7 between its kernel and its gather; 1e-6 times
sqrt(d_head / 16) at wider heads, whose scores sum more terms), and at GQA
groups 3, 5, 16 and 32 with d_head 80 and 256. The port's plain version
(``paged_attention_reference``) is held to the JAX gather too, and the
CUDA wrapper's shape check takes every width the kernel does.
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


#: GQA groups 3, 5, 16 and 32 at d_head 80 and 256: the groups past the
#: kernel's first set (1, 2, 4, 8) and the widths it runs padded
WIDE_CASES = [pytest.param(kv_heads, group * kv_heads, page_size, d_head,
                           id=f"group{group}-d{d_head}")
              for kv_heads, group, page_size, d_head in (
                  (1, 3, 8, 80), (2, 3, 16, 256), (1, 5, 16, 80),
                  (2, 5, 8, 256), (1, 16, 16, 80), (1, 16, 8, 256),
                  (1, 32, 8, 80), (1, 32, 16, 256))]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("kv_heads,heads,page_size,d_head", [
    pytest.param(4, 4, 8, 16, id="4-4-8"),
    pytest.param(2, 4, 16, 16, id="2-4-16")] + WIDE_CASES)
def test_plain_version_matches_jax_kernel(quant, kv_heads, heads, page_size,
                                          d_head):
    case = paged_case(page_size + kv_heads + d_head, heads=heads,
                      kv_heads=kv_heads, page_size=page_size, quant=quant,
                      d_head=d_head)
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
    # a score sums d_head products: the two orders of summation drift apart
    # by about the square root of the terms (1.1e-6 seen at d_head 256)
    tol = TOL * max(1.0, (d_head / 16) ** 0.5)
    np.testing.assert_allclose(out.numpy(), expected, atol=tol, rtol=0)
    # the plain version against the JAX gather dispatch
    gather = paged_attention_reference(tq, tk, tv, ttable, tpos,
                                       k_scales=tks, v_scales=tvs)
    jax_gather = jax_decode._paged_attend(q, k, v, table, positions,
                                          use_kernel=False, k_scales=k_scales,
                                          v_scales=v_scales)
    np.testing.assert_allclose(gather.numpy(), np.asarray(jax_gather),
                               atol=tol, rtol=0)


def test_resolve_paged_kernel_knob():
    assert resolve_paged_kernel("on") == "cuda"
    assert resolve_paged_kernel("auto") == "cuda"
    # the plain gather as an operator choice would run it on the card
    with pytest.raises(ValueError, match="paged_kernel='off'"):
        resolve_paged_kernel("off")
    with pytest.raises(ValueError, match="paged_kernel"):
        resolve_paged_kernel("pallas")


@pytest.mark.parametrize("d_head", [16, 80, 144, 256, 72, 272])
def test_cuda_shape_check_takes_every_group_and_multiple_of_16(d_head):
    """The CUDA wrapper's shape check (run before any launch) takes any GQA
    group (here 48 query heads over 1 kv head: StarCoder's MQA) at every
    d_head that is a multiple of 16 up to 256, and refuses other widths
    with a message naming that set."""
    q = torch.zeros((2, 1, 48, d_head))
    pages = torch.zeros((3, 16, 1, d_head))
    table = torch.zeros((2, 4), dtype=torch.int32)
    positions = torch.zeros(2, dtype=torch.int32)
    if d_head % 16 == 0 and d_head <= 256:
        paged_module._check_inputs(q, pages, pages, table, positions, None,
                                   None)
        return
    with pytest.raises(ValueError, match="multiple of 16 from 16 to 256"):
        paged_module._check_inputs(q, pages, pages, table, positions, None,
                                   None)
