"""The port's flash-attention backward against the JAX kernels.

The same q/k/v/dO, drawn from a numpy seed, go through the JAX backward
(``_flash_bwd_bhsd`` in Pallas interpret mode, as the JAX package's own
tests run it) and through the port's ``flash_attention_backward`` on CPU
tensors — the plain version the CUDA kernels are held to on the card.
f32 dq/dk/dv agree within 2e-4 abs and rel (the JAX package's own bound
for its backward, ``tests/unit/test_compute.py``), causal and not, GQA
groups 1/2/4, d_head 32/64, with an explicit scale and delta. Autograd
through ``flash_attention`` agrees with ``jax.grad`` through the JAX
``flash_attention``. The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu.ops.flash_attention import (
    _flash_bwd_bhsd,
    _flash_fwd_bhsd,
)
from tensorhive_tpu.ops.flash_attention import flash_attention as jax_flash
from tensorhive_tpu.ops.flash_attention import (
    flash_bwd_delta as jax_delta,
)
from tensorhive_tpu_torch.ops import flash_attention as flash_module
from tensorhive_tpu_torch.ops.flash_attention import (
    _fold_scale_into_q,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_bwd_delta,
)

TOL = 2e-4


def draw(seed, batch, seq, heads, kv_heads, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = [(batch, seq, heads, d), (batch, seq, kv_heads, d),
              (batch, seq, kv_heads, d), (batch, seq, heads, d)]
    return [rng.standard_normal(shape, np.float32).astype(dtype)
            for shape in shapes]


def to_bhsd(x):
    batch, seq, heads, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(batch * heads, seq, d))


def from_bhsd(x, batch, heads):
    x = np.asarray(x, np.float32)
    return x.reshape(batch, heads, x.shape[1], x.shape[2]).transpose(0, 2, 1, 3)


def jax_backward(q, k, v, do, causal, scale=None, with_delta=False):
    """(dq, dk, dv) from the JAX kernels, in [B, S, H, D], plus the
    forward's O and LSE."""
    batch, _, heads, _ = q.shape
    kv_heads = k.shape[2]
    out, lse = _flash_fwd_bhsd(to_bhsd(q), to_bhsd(k), to_bhsd(v), causal,
                               64, 64, True, scale=scale)
    delta = jax_delta(to_bhsd(do), out) if with_delta else None
    grads = _flash_bwd_bhsd(to_bhsd(q), to_bhsd(k), to_bhsd(v), out, lse,
                            to_bhsd(do), causal, 64, 64, True, scale=scale,
                            delta=delta)
    shaped = [from_bhsd(g, batch, h)
              for g, h in zip(grads, (heads, kv_heads, kv_heads))]
    return shaped, from_bhsd(out, batch, heads), np.asarray(lse)


@pytest.mark.parametrize("causal,heads,kv_heads,d", [
    (True, 4, 4, 32), (True, 4, 2, 64), (True, 8, 2, 32),
    (False, 4, 4, 64), (False, 4, 1, 32), (False, 8, 2, 64)])
def test_backward_matches_jax_kernels(causal, heads, kv_heads, d):
    batch, seq = 2, 128
    q, k, v, do = draw(d + heads * 3 + kv_heads, batch, seq, heads,
                       kv_heads, d)
    expected, _, _ = jax_backward(q, k, v, do, causal)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash_attention(tq, tk, tv, causal=causal, return_lse=True)
    before = dict(flash_module.launches)
    grads = flash_attention_backward(tq, tk, tv, out, lse, tdo,
                                     causal=causal)
    assert flash_module.launches == before      # CPU: no kernel launch
    for grad, want, like in zip(grads, expected, (tq, tk, tv)):
        assert grad.shape == like.shape and grad.dtype == torch.float32
        np.testing.assert_allclose(grad.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("scale", [0.25, 0.3])
def test_explicit_scale_and_delta_match_jax(scale):
    """Ring attention's call: non-causal, its own scale and a delta made
    beforehand. 0.25 is a power of two (folded into q by the JAX rule),
    0.3 is not (it stays on the f32 scores)."""
    q, k, v, do = draw(11, 1, 128, 4, 2, 32)
    expected, jax_out, jax_lse = jax_backward(q, k, v, do, False,
                                              scale=scale, with_delta=True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash_attention(tq, tk, tv, causal=False, scale=scale,
                               return_lse=True)
    np.testing.assert_allclose(out.numpy(), jax_out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), jax_lse, atol=1e-5, rtol=0)
    delta = flash_bwd_delta(tdo, out)
    np.testing.assert_allclose(
        delta.numpy(), np.asarray(jax_delta(to_bhsd(do), to_bhsd(out.numpy()))),
        atol=1e-5, rtol=1e-6)
    grads = flash_attention_backward(tq, tk, tv, out, lse, tdo, causal=False,
                                     scale=scale, delta=delta)
    for grad, want in zip(grads, expected):
        np.testing.assert_allclose(grad.numpy(), want, atol=TOL, rtol=TOL)


def test_bf16_backward_rounds_where_jax_rounds():
    """bf16 inputs: P and dS are rounded to bf16 before their products on
    both sides, so the port's plain backward stays within a bf16 rounding
    of the JAX kernels, held per gradient row."""
    batch, heads, kv_heads = 1, 4, 2
    q, k, v, do = draw(5, batch, 128, heads, kv_heads, 64)
    cast = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do)]
    as_bhsd = [jnp.asarray(np.asarray(to_bhsd(np.asarray(a, np.float32))),
                           jnp.bfloat16) for a in cast]
    out, lse = _flash_fwd_bhsd(*as_bhsd[:3], True, 64, 64, True)
    expected = _flash_bwd_bhsd(*as_bhsd[:3], out, lse, as_bhsd[3], True, 64,
                               64, True)
    tensors = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
               for a in cast]
    t_out = torch.from_numpy(from_bhsd(out, batch, heads)).to(torch.bfloat16)
    t_lse = torch.from_numpy(np.array(lse))
    grads = flash_attention_backward(*tensors[:3], t_out, t_lse, tensors[3],
                                     causal=True)
    for grad, want, h, name in zip(grads, expected,
                                   (heads, kv_heads, kv_heads), "qkv"):
        assert grad.dtype == torch.bfloat16
        want = from_bhsd(want, batch, h)
        diff = np.linalg.norm(grad.float().numpy() - want, axis=-1)
        norm = np.linalg.norm(want, axis=-1)
        rel = diff / np.maximum(norm, 1e-30)
        if name == "q":
            # dq of query 0 is zero in exact arithmetic (its softmax sees
            # one key), rounding noise on both sides: held against the
            # largest dq row
            rel[:, 0] = diff[:, 0] / norm.max()
        assert rel.max() <= 1e-2


def test_autograd_matches_jax_grad():
    """torch.autograd through flash_attention (the autograd Function's
    saved O/LSE and plain backward on CPU tensors) against jax.grad
    through the JAX flash_attention in interpret mode, GQA."""
    q, k, v, weight = draw(3, 2, 128, 4, 2, 32)

    def jax_loss(q, k, v):
        out = jax_flash(q, k, v, causal=True, interpret=True)
        return jnp.sum(out * jnp.asarray(weight))

    expected = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    loss = (flash_attention(*leaves, causal=True)
            * torch.from_numpy(weight)).sum()
    grads = torch.autograd.grad(loss, leaves)
    for grad, want in zip(grads, expected):
        np.testing.assert_allclose(grad.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)


def test_reference_is_autograd_of_plain_attention():
    """The plain backward equals autograd through the plain forward at a
    ragged length (S = 100) — the ground truth the kernels' masks need."""
    q, k, v, do = (torch.from_numpy(a) for a in draw(8, 1, 100, 4, 1, 16))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_module.reference_attention(*leaves, causal=True)
    expected = torch.autograd.grad(out, leaves, do)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    grads = flash_attention_backward_reference(q, k, v, out, lse, do)
    for grad, want in zip(grads, expected):
        torch.testing.assert_close(grad, want, atol=1e-5, rtol=1e-5)


def test_fold_scale_rule():
    q = torch.randn(2, 3, dtype=torch.bfloat16)
    folded, residual = _fold_scale_into_q(q, 0.125)
    assert residual == 1.0 and torch.equal(folded, q * 0.125)
    same, residual = _fold_scale_into_q(q, 128 ** -0.5)
    assert residual == 128 ** -0.5 and same is q
    assert _fold_scale_into_q(q, 1.0) == (q, 1.0)


def test_backward_refuses_other_devices():
    q = torch.zeros((1, 4, 2, 16), device="meta")
    lse = torch.zeros((2, 1, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_backward(q, q, q, q, lse, q)
