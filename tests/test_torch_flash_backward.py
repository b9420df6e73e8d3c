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

The f32 kernels take Q K^T and the gradient products on the tensor cores
in TF32, split into three passes (x = hi + lo, a_hi b_hi + a_hi b_lo +
a_lo b_hi), and dP = dO V^T in f64. An emulation of that arithmetic here
holds the card's f32 measure (no gradient row further from the f64
evaluation than the exact-f32 plain version's, by more than 2e-5 of the
row); a single TF32 pass does not, and neither does a dP with f32 error
where rows cancel (q x 4).
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


# -- the f32 kernels' arithmetic, emulated ------------------------------------

F32_GRAD_ROW_TOL = 2e-5     # the card's bound for the f32 kernels


def tf32_round(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero: cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(x):
    """x as a TF32 product operand reads it: the low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def matmul_split(a, b, arithmetic):
    """a @ b in f32 by the named arithmetic: "tf32" one TF32 pass (hi x
    hi); "3xtf32" three (lo x hi, hi x lo, then hi x hi, with hi the TF32
    rounding and the product reading lo = x - hi truncated); "f32" exact
    f32 products summed over the contraction in two halves (an order of its
    own); "f64" the f64 product. Every TF32 x TF32 product is exact in
    f32; the sums run in f32 (f64 for "f64", returned in f64)."""
    if arithmetic == "f64":
        return a.double() @ b.double()
    if arithmetic == "f32":
        half = a.shape[-1] // 2
        return (a[..., :half] @ b[..., :half, :]
                + a[..., half:] @ b[..., half:, :])
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    if arithmetic == "tf32":
        return a_hi @ b_hi
    a_lo, b_lo = tf32_truncate(a - a_hi), tf32_truncate(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def emulated_backward(q, k, v, out, lse, do, causal, products, dp_product):
    """The backward's function with its products made by ``products`` and
    dP = dO V^T by ``dp_product`` (see ``matmul_split``); dP - delta is
    rounded to f32 once. The f32 kernels are ("3xtf32", "f64"). (dq, dk,
    dv) in [B, S, H, D]."""
    batch, seq, heads, d = q.shape
    kv_heads = k.shape[2]
    scale = d ** -0.5

    def heads_first(x):
        return x.repeat_interleave(heads // x.shape[2], dim=2).transpose(1, 2)

    qh, kh, vh, doh = (heads_first(x) for x in (q, k, v, do))
    delta = flash_bwd_delta(do, out).reshape(batch, heads, seq, 1)
    scores = matmul_split(qh, kh.transpose(-1, -2), products) * scale
    visible = torch.ones(seq, seq, dtype=torch.bool)
    if causal:
        visible = visible.tril()
    probs = torch.where(visible, (scores - lse.reshape(batch, heads, seq, 1)
                                  ).exp(), torch.zeros(()))
    dp = matmul_split(doh, vh.transpose(-1, -2), dp_product)
    ds = probs * (dp - delta.to(dp.dtype)).float()
    dq = matmul_split(ds, kh, products) * scale
    dk = matmul_split(ds.transpose(-1, -2), qh, products) * scale
    dv = matmul_split(probs.transpose(-1, -2), doh, products)

    def layout(x, h):
        x = x.transpose(1, 2)
        return x.reshape(batch, seq, h, heads // h, d).sum(3)

    return layout(dq, heads), layout(dk, kv_heads), layout(dv, kv_heads)


def row_errors(grads, refs, exact, causal):
    """Over dq, dk, dv: the largest row ||grad - plain|| / ||plain|| (the
    distance from the plain f32 version) and the largest row (||grad -
    exact|| - ||plain - exact||) / ||exact|| (the card's f32 measure:
    beyond the plain f32 version's own error). dq of query 0 under the
    causal mask (zero in exact arithmetic) against the largest dq row, as
    on the card."""
    vs_plain = beyond = 0.0
    for grad, ref, ex, name in zip(grads, refs, exact, "qkv"):
        norms, exact_norms = ref.norm(dim=-1), ex.norm(dim=-1)
        if causal and name == "q":
            norms[:, 0], exact_norms[:, 0] = norms.max(), exact_norms.max()
        vs_plain = max(vs_plain, ((grad - ref).norm(dim=-1)
                                  / norms.clamp_min(1e-30)).max().item())
        own = (ref.double() - ex).norm(dim=-1)
        error = (grad.double() - ex).norm(dim=-1)
        beyond = max(beyond, ((error - own)
                              / exact_norms.clamp_min(1e-300)).max().item())
    return vs_plain, beyond


def emulation_case(causal, seq, heads, kv_heads, d, q_scale=1.0, batch=2):
    q, k, v, do = (torch.from_numpy(a) for a in
                   draw(seq + d + heads, batch, seq, heads, kv_heads, d))
    q = q * q_scale
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    delta = flash_bwd_delta(do, out)
    refs = flash_attention_backward_reference(q, k, v, out, lse, do,
                                              causal=causal, delta=delta)
    exact = flash_attention_backward_reference(
        *(t.double() for t in (q, k, v, out, lse, do)), causal=causal,
        delta=delta.double())
    return (q, k, v, out, lse, do), refs, exact


TF32_SHAPES = [(True, 100, 4, 2, 16), (False, 100, 4, 2, 64),
               (True, 77, 4, 4, 64), (False, 130, 2, 2, 16)]
#: q x 4: scores of std about 4, rows whose softmax saturates cancel
LARGE_SCORE_SHAPES = [(True, 200, 4, 2, 64, 4.0, 2),
                      (True, 300, 4, 1, 32, 4.0, 1)]


@pytest.mark.parametrize("causal,seq,heads,kv_heads,d", TF32_SHAPES)
def test_three_pass_tf32_holds_the_f32_bound(causal, seq, heads, kv_heads, d):
    """The f32 kernels' arithmetic (three TF32 passes per product, dP in
    f64) within 2e-5 per row of the exact-f32 plain backward, and within
    the card's f32 measure: causal and not, GQA group 2, ragged S, d_head
    16 and 64."""
    inputs, refs, exact = emulation_case(causal, seq, heads, kv_heads, d)
    grads = emulated_backward(*inputs, causal, "3xtf32", "f64")
    vs_plain, beyond = row_errors(grads, refs, exact, causal)
    assert vs_plain <= F32_GRAD_ROW_TOL and beyond <= F32_GRAD_ROW_TOL


@pytest.mark.parametrize("causal,seq,heads,kv_heads,d", TF32_SHAPES)
def test_single_pass_tf32_misses_the_f32_bound(causal, seq, heads, kv_heads,
                                               d):
    """One TF32 pass keeps about three decimal digits: on the same inputs
    it fails the card's f32 measure (and 2e-5 of the plain version), so the
    measure tells a single pass apart."""
    inputs, refs, exact = emulation_case(causal, seq, heads, kv_heads, d)
    grads = emulated_backward(*inputs, causal, "tf32", "tf32")
    vs_plain, beyond = row_errors(grads, refs, exact, causal)
    assert vs_plain > F32_GRAD_ROW_TOL and beyond > F32_GRAD_ROW_TOL


@pytest.mark.parametrize("causal,seq,heads,kv_heads,d,q_scale,batch",
                         LARGE_SCORE_SHAPES)
def test_f64_dp_holds_the_f32_measure_on_large_scores(
        causal, seq, heads, kv_heads, d, q_scale, batch):
    """Under q x 4 rows cancel, the plain f32 version is far from exact on
    them, and so is the kernels' arithmetic — by more than 2e-5 of the
    plain version — yet no row of it is further from exact than the plain
    f32 version's own row (+ 2e-5): dP - delta is rounded once from f64."""
    inputs, refs, exact = emulation_case(causal, seq, heads, kv_heads, d,
                                         q_scale, batch)
    grads = emulated_backward(*inputs, causal, "3xtf32", "f64")
    vs_plain, beyond = row_errors(grads, refs, exact, causal)
    assert vs_plain > F32_GRAD_ROW_TOL and beyond <= F32_GRAD_ROW_TOL


@pytest.mark.parametrize("dp_product", ["3xtf32", "f32"])
@pytest.mark.parametrize("causal,seq,heads,kv_heads,d,q_scale,batch",
                         LARGE_SCORE_SHAPES)
def test_f32_error_in_dp_misses_the_f32_measure(causal, seq, heads, kv_heads,
                                                d, q_scale, batch,
                                                dp_product):
    """Why the kernels take dP in f64: with dP (and every other product)
    made by three TF32 passes, or by exact f32 products summed in another
    order than the plain version's, some cancelling row ends further from
    exact than the plain f32 version's by more than 2e-5."""
    inputs, refs, exact = emulation_case(causal, seq, heads, kv_heads, d,
                                         q_scale, batch)
    grads = emulated_backward(*inputs, causal, dp_product, dp_product)
    assert row_errors(grads, refs, exact, causal)[1] > F32_GRAD_ROW_TOL


def test_tf32_rounding_helpers():
    """hi rounds to nearest, ties away from zero (cvt.rna); an operand's
    low 13 bits are dropped (truncation)."""
    ulp = 2.0 ** -10                        # TF32 spacing at 1
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 4, -(1 + ulp / 2),
                      1 + 3 * ulp / 4], dtype=torch.float32)
    assert tf32_round(x).tolist() == [1 + ulp, 1.0, -(1 + ulp), 1 + ulp]
    assert tf32_truncate(x).tolist() == [1.0, 1.0, -1.0, 1.0]
    lo = x - tf32_round(x)
    assert torch.equal(tf32_round(x) + lo, x)      # the split is exact
