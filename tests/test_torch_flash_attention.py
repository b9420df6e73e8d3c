"""The port's flash-attention forward against the JAX kernel.

The same q/k/v, drawn from a numpy seed, go through the JAX forward kernel
(``_flash_fwd_bhsd`` in Pallas interpret mode, as the JAX package's own
tests run it) and through the port's ``flash_attention`` on CPU tensors,
which is the plain version the CUDA kernel is held to. O and LSE agree
within 1e-5 abs in f32 (accumulation order only), causal and not, MHA and
GQA, d_head 16 and 64. The CUDA kernel itself runs only on the card
(``python3 chip_smoke.py``).
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


@pytest.mark.parametrize("causal,heads,kv_heads,d", [
    (True, 4, 4, 16), (True, 4, 2, 64), (False, 4, 2, 16), (False, 4, 4, 64)])
def test_forward_matches_jax_kernel(causal, heads, kv_heads, d):
    batch, seq = 2, 128
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
