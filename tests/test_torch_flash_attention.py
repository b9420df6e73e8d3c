"""The port's flash-attention forward against the JAX kernel.

The same q/k/v, drawn from a numpy seed, go through the JAX forward kernel
(``_flash_fwd_bhsd`` in Pallas interpret mode, as the JAX package's own
tests run it) and through the port's ``flash_attention`` on CPU tensors,
which is the plain version the CUDA kernel is held to. O and LSE agree
within 1e-5 abs in f32 (accumulation order only), causal and not, MHA and
GQA, d_head 16 and 64, and d_head 80, 96 and 256 at groups 1, 3 and 7 (the
widths the kernels run in a padded body). The CUDA kernel itself runs only
on the card (``python3 chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu.ops.flash_attention import _flash_fwd_bhsd
from tensorhive_tpu.ops.flash_attention import (
    reference_attention as jax_reference,
)
from tensorhive_tpu_torch.ops import flash_attention as flash_module
from tensorhive_tpu_torch.ops.flash_attention import (
    flash_attention,
    reference_attention,
)

TOL = 1e-5


def draw(seed, batch, seq, heads, kv_heads, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, seq, heads, d), np.float32)
    k = rng.standard_normal((batch, seq, kv_heads, d), np.float32)
    v = rng.standard_normal((batch, seq, kv_heads, d), np.float32)
    return q, k, v


def to_bhsd(x):
    batch, seq, heads, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(batch * heads, seq, d))


#: the widths and GQA groups of public models past the kernels' first set:
#: d_head 80 (Phi-2), 96 (Phi-3-mini) and 256 (Gemma-2B), at groups 1, 3
#: and 7 (Qwen2.5-7B's 28 / 4)
WIDE_SHAPES = [(causal, group * kv_heads, kv_heads, d)
               for (d, causal), (group, kv_heads) in zip(
                   [(80, True), (80, False), (80, True), (96, False),
                    (96, True), (96, True), (256, True), (256, False),
                    (256, True)],
                   [(1, 2), (3, 1), (7, 1)] * 3)]


@pytest.mark.parametrize("causal,heads,kv_heads,d", [
    (True, 4, 4, 16), (True, 4, 2, 64), (False, 4, 2, 16), (False, 4, 4, 64)]
    + WIDE_SHAPES)
def test_forward_matches_jax_kernel(causal, heads, kv_heads, d):
    batch, seq = 2 if d <= 64 else 1, 128
    q, k, v = draw(d + heads + kv_heads, batch, seq, heads, kv_heads, d)
    jax_out, jax_lse = _flash_fwd_bhsd(to_bhsd(q), to_bhsd(k), to_bhsd(v),
                                       causal, 64, 64, True)
    jax_out = np.asarray(jax_out).reshape(batch, heads, seq, d
                                          ).transpose(0, 2, 1, 3)
    before = dict(flash_module.launches)
    out, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               return_lse=True)
    assert flash_module.launches == before      # CPU: no kernel launch
    assert out.shape == q.shape and out.dtype == torch.float32
    assert lse.shape == (batch * heads, 1, seq) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), jax_out, atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax_lse), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("seq", [100, 1])
def test_ragged_length_matches_jax_reference(seq):
    """A length no block divides (the JAX dispatch falls back to its
    reference there; the port's kernel masks the ragged tile)."""
    q, k, v = draw(seq, 1, seq, 4, 2, 16)
    expected = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True))
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(out.numpy(), expected, atol=TOL, rtol=0)


def test_explicit_scale_and_bf16_rounding():
    """``scale`` reaches the scores, and a bf16 call returns bf16 computed
    in f32 from the bf16 values (the kernel's contract)."""
    q, k, v = (torch.from_numpy(a) for a in draw(3, 1, 32, 2, 2, 16))
    half = reference_attention(q, k, v, causal=False, scale=0.5)
    scaled_q = reference_attention(q * 0.5 / 16 ** -0.5, k, v, causal=False)
    torch.testing.assert_close(half, scaled_q, atol=1e-5, rtol=1e-5)
    low = [t.to(torch.bfloat16) for t in (q, k, v)]
    out = flash_attention(*low, causal=True)
    expected = reference_attention(*(t.float() for t in low), causal=True)
    assert out.dtype == torch.bfloat16
    # bf16 keeps 8 significant bits: rounding moves a value by <= 2^-8 of it
    torch.testing.assert_close(out.float(), expected, atol=1e-6,
                               rtol=2 ** -8)


@pytest.mark.parametrize("d", list(range(16, 257, 16)) + [72, 272, 8])
def test_cuda_shape_check_takes_every_multiple_of_16_to_256(d):
    """The CUDA wrapper's shape check (run before any launch) takes every
    d_head that is a multiple of 16 from 16 to 256 at any GQA group, and
    refuses other widths with a message naming that set."""
    q = torch.zeros((5, 3, 21, d))
    k = torch.zeros((5, 3, 3, d))
    assert flash_module.HEAD_DIMS == tuple(range(16, 257, 16))
    if d % 16 == 0 and d <= 256:
        flash_module._check_inputs(q, k, k)
        return
    with pytest.raises(ValueError, match="multiple of 16 from 16 to 256") \
            as raised:
        flash_module._check_inputs(q, k, k)
    assert "16, 32, 48" in str(raised.value)
    assert "240, 256" in str(raised.value)


def test_cuda_shape_check_takes_any_batch_times_heads():
    """B * H past grid y's 65535 is no limit (the launches split the rows),
    as in JAX, where an MLM batch of 8192 x 8 heads reaches 65536."""
    q = torch.zeros((8193, 1, 8, 16))
    flash_module._check_inputs(q, q, q)
