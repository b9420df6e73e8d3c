"""The f32 flash forward's arithmetic, emulated on the CPU.

The f32 kernels of ``csrc/flash_fwd.cu`` (per-head and head-blocked) take
S = Q K^T and O = P V on the tensor cores, each as three TF32 products of a
split x = hi + lo (a_lo b_hi + a_hi b_lo + a_hi b_hi; hi the TF32 rounding,
lo = x - hi read truncated), with the online softmax in f32. The emulation
here makes both products that way (``matmul_split`` of the backward's
tests; the exponentials as the plain version takes them, the kernels'
ex2.approx being measured on the card) on the same numpy-drawn inputs as
the plain version and holds it to
the card's f32 forward checks: max |O - plain| <= 1e-5 and |LSE - plain| <=
5e-5 at N(0, 1) inputs, and the f64 measure, no output row (the d_head
values of one token and head) further from the f64 evaluation than the
plain f32 version's own row by more than 2e-5 of the row, also with q x 4
(scores of std about 4, where the plain version itself is ~1e-5 from
exact). One TF32 pass fails the measure. The emulated arithmetic also
agrees with the JAX forward kernel (Pallas, interpret mode) within 1e-5.
The kernels themselves run only on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from tensorhive_tpu.ops.flash_attention import _flash_fwd_bhsd
from tensorhive_tpu_torch.ops.flash_attention import (
    NEG_INF,
    reference_attention,
)
from tests.test_torch_flash_backward import draw, matmul_split, to_bhsd

ABS_TOL = 1e-5          # the card's f32 bound against the plain version
LSE_TOL = 5e-5
ROW_EXCESS = 2e-5       # the card's f64 measure


def emulated_forward(q, k, v, causal, arithmetic):
    """(O [B, S, H, D], LSE [B*H, 1, S]) with S = Q K^T and P V made by
    ``arithmetic`` (see ``matmul_split``): x = s * scale, p = exp(x - max)
    with masked scores exactly 0, O = (P V) / rowsum(p), LSE = max +
    log(rowsum(p)) — the kernels' function, their products' rounding."""
    batch, seq, heads, d = q.shape
    group = heads // k.shape[2]
    qh = q.transpose(1, 2)
    kh, vh = (x.repeat_interleave(group, dim=2).transpose(1, 2)
              for x in (k, v))
    scores = matmul_split(qh, kh.transpose(-1, -2), arithmetic) * d ** -0.5
    visible = torch.ones(seq, seq, dtype=torch.bool)
    if causal:
        visible = visible.tril()
    scores = torch.where(visible, scores, torch.full((), NEG_INF))
    top = scores.amax(dim=-1, keepdim=True)
    probs = torch.where(visible, (scores - top).exp(), torch.zeros(()))
    total = probs.sum(dim=-1, keepdim=True)
    out = matmul_split(probs, vh, arithmetic) / total
    lse = (top + total.log()).reshape(batch * heads, 1, seq)
    return out.transpose(1, 2), lse


def row_excess(out, plain, exact):
    """max over output rows of (||out - exact|| - ||plain - exact||) /
    ||exact||: the card's f64 measure."""
    exact = exact.double()
    error = (out.double() - exact).norm(dim=-1)
    own = (plain.double() - exact).norm(dim=-1)
    return ((error - own) / exact.norm(dim=-1).clamp_min(1e-300)).max().item()


def case(causal, seq, heads, kv_heads, d, q_scale=1.0, batch=2):
    q, k, v, _ = (torch.from_numpy(a) for a in
                  draw(seq + d + heads, batch, seq, heads, kv_heads, d))
    q = q * q_scale
    plain, plain_lse = reference_attention(q, k, v, causal=causal,
                                           return_lse=True)
    exact = reference_attention(q.double(), k.double(), v.double(),
                                causal=causal)
    return (q, k, v), plain, plain_lse, exact


#: causal and not, GQA group 2, ragged S, d_head 16 and 64
FWD_SHAPES = [(True, 100, 4, 2, 16), (False, 100, 4, 2, 64),
              (True, 77, 4, 4, 64), (False, 130, 2, 2, 16),
              (True, 300, 4, 2, 64)]
#: q x 4, causal and not
LARGE_SCORE_SHAPES = [(True, 200, 4, 2, 64), (False, 150, 4, 2, 16),
                      (True, 300, 4, 1, 64)]


@pytest.mark.parametrize("causal,seq,heads,kv_heads,d", FWD_SHAPES)
def test_three_pass_tf32_forward_holds_the_f32_bounds(causal, seq, heads,
                                                      kv_heads, d):
    inputs, plain, plain_lse, exact = case(causal, seq, heads, kv_heads, d)
    out, lse = emulated_forward(*inputs, causal, "3xtf32")
    assert (out - plain).abs().max().item() <= ABS_TOL
    assert (lse - plain_lse).abs().max().item() <= LSE_TOL
    assert row_excess(out, plain, exact) <= ROW_EXCESS


@pytest.mark.parametrize("causal,seq,heads,kv_heads,d", LARGE_SCORE_SHAPES)
def test_three_pass_tf32_forward_holds_the_measure_on_large_scores(
        causal, seq, heads, kv_heads, d):
    inputs, plain, _, exact = case(causal, seq, heads, kv_heads, d, 4.0)
    out, _ = emulated_forward(*inputs, causal, "3xtf32")
    assert row_excess(out, plain, exact) <= ROW_EXCESS


@pytest.mark.parametrize("causal,seq,heads,kv_heads,d,q_scale",
                         [shape + (1.0,) for shape in FWD_SHAPES]
                         + [shape + (4.0,) for shape in LARGE_SCORE_SHAPES])
def test_single_pass_tf32_forward_fails_the_measure(causal, seq, heads,
                                                    kv_heads, d, q_scale):
    """One TF32 pass per product keeps about three decimal digits: the
    measure tells it from the kernels' arithmetic on the same inputs."""
    inputs, plain, _, exact = case(causal, seq, heads, kv_heads, d, q_scale)
    out, _ = emulated_forward(*inputs, causal, "tf32")
    assert row_excess(out, plain, exact) > ROW_EXCESS
    assert (out - plain).abs().max().item() > ABS_TOL


@pytest.mark.parametrize("causal,heads,kv_heads,d", [
    (True, 4, 2, 64), (False, 4, 4, 16)])
def test_three_pass_tf32_forward_matches_jax_kernel(causal, heads, kv_heads,
                                                    d):
    batch, seq = 2, 128
    q, k, v, _ = draw(d + heads + kv_heads, batch, seq, heads, kv_heads, d)
    jax_out, jax_lse = _flash_fwd_bhsd(to_bhsd(q), to_bhsd(k), to_bhsd(v),
                                       causal, 64, 64, True)
    jax_out = np.asarray(jax_out).reshape(batch, heads, seq, d
                                          ).transpose(0, 2, 1, 3)
    out, lse = emulated_forward(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal, "3xtf32")
    np.testing.assert_allclose(out.numpy(), jax_out, atol=ABS_TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax_lse),
                               atol=ABS_TOL, rtol=0)
