"""The CUDA kernels against their plain versions at every head dim, GQA
group, head block and page type they accept, and the tiny engine on the
card against the same engine on the CPU. The head-blocked flash forward
is also held bitwise to the per-head kernel, whose per-tile code it runs,
and the flash backward bitwise to itself over two launches (no atomics).

These tests need the card and skip without a CUDA device. On the card,
where JAX is not installed, run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``chip_smoke.py`` covers the main path's shapes.) Tolerances: f32 outputs
1e-5 abs (accumulation order only). bf16 outputs against the f32 plain
version on the same bf16 values: the kernel rounds its output, and the
flash kernel its probabilities, to bf16, an error that scales with the
output row, so each row (the d_head values of one token and head) is held
to ||out - plain||_2 / ||plain||_2 <= 1e-2. The f32 flash forward's O is
also held to the plain version evaluated in f64 on the same inputs
(``exact``), as the f32 backward's gradients are below: no row further from
it than the plain f32 version's own row by more than 2e-5 of the row,
||O - exact|| <= ||plain - exact|| + 2e-5 ||exact||, also with q x 4
(scores of std about 4, where the 1e-5 abs bound is not the measure: the
plain version itself is ~1e-5 from exact there). The f32 forward takes Q
K^T and P V as three TF32 products each; the plain forward with
single-pass TF32 matmuls fails the measure (the control test).

Backward gradients (dq, dk, dv) are held per row. bf16 against the plain
backward on the same inputs, ||grad - plain||_2 / ||plain||_2 <= 1e-2 (P
and dS rounded to bf16 at the same places on both sides, the gradients
rounded once). f32 against the plain backward evaluated in f64 on the same
inputs (``exact``): no row may be further from it than the exact-f32
plain version's own row, by more than 2e-5 of the row, ||grad - exact||
<= ||plain - exact|| + 2e-5 ||exact||. On most rows that is about 2e-5 of
exact; a row that cancels to a small part of its terms (a causal row that
sees two keys, a saturated softmax) is one where f32 arithmetic itself is
far from exact, and there the kernel may be no worse than the plain f32
version. The f32 kernels take Q K^T and the gradient products as three
TF32 products each and dO V^T in f64; the plain backward with single-pass
TF32 matmuls fails the measure (the control test). Rows that are zero in
exact arithmetic are rounding noise in both versions, and no relative
bound can hold noise to noise: dq of the first query under the causal
mask (its softmax sees one key) is held to the same bound times the
largest dq row norm, and at S = 1, where every dq and dk row is zero,
those rows are held to 2e-5 abs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tensorhive_tpu_torch.ops import flash_attention as fa
from tensorhive_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

ABS_TOL = 1e-5
ROW_REL_TOL = 1e-2
LSE_TOL = 5e-5
GRAD_ROW_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}
FWD_ROW_EXCESS = 2e-5
ZERO_GRAD_ABS = 2e-5
# card (kernels) vs CPU (plain versions through MKL), f32: the CPU sums and
# exponentiates in its own order, ~1e-4 of a row where dS cancels
CARD_VS_CPU_TOL = 1e-4


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def assert_close_to_plain(out, ref):
    diff = out.float() - ref
    if out.dtype == torch.bfloat16:
        row_rel = diff.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
        assert row_rel.max().item() <= ROW_REL_TOL
    else:
        assert diff.abs().max().item() <= ABS_TOL


def grad_row_error(grad, ref, first_row_zero=False):
    """max over the rows of a [B, S, H, D] gradient of ||grad - ref|| /
    ||ref||; with ``first_row_zero`` the rows of token 0 (zero in exact
    arithmetic) over the largest ||ref|| row instead."""
    norms = ref.float().norm(dim=-1)
    assert norms.max().item() > 0, "the plain gradient is all zeros"
    diff = (grad.float() - ref.float()).norm(dim=-1)
    rel = diff / norms.clamp_min(1e-30)
    if first_row_zero:
        rel[:, 0] = diff[:, 0] / norms.max()
    return rel.max().item()


def f32_row_error(grad, plain, exact, first_row_zero=False):
    """max over the rows of a [B, S, H, D] f32 gradient (or forward output)
    of (||grad - exact|| - ||plain - exact||) / ||exact||, ``exact`` the
    plain version in f64 and ``plain`` the exact-f32 plain version; with
    ``first_row_zero`` the rows of token 0 over the largest ||exact||
    row."""
    exact = exact.double()
    norms = exact.norm(dim=-1)
    assert norms.max().item() > 0, "the plain gradient is all zeros"
    if first_row_zero:
        norms[:, 0] = norms.max()
    error = (grad.double() - exact).norm(dim=-1)
    own = (plain.double() - exact).norm(dim=-1)
    return ((error - own) / norms.clamp_min(1e-300)).max().item()


def exact_backward(q, k, v, out, lse, do, causal, scale=None, delta=None):
    """The plain backward evaluated in f64 on the f32 inputs, with the
    delta the kernel reads (the f32 rowsum(dO * O) unless given)."""
    if delta is None:
        delta = fa.flash_bwd_delta(do, out)
    return fa.flash_attention_backward_reference(
        *(t.double() for t in (q, k, v, out, lse, do)), causal=causal,
        scale=scale, delta=delta.double())


def normal(generator, shape, dtype):
    return torch.randn(shape, generator=generator, device=generator.device
                       ).to(dtype)


# S 129 and 255 cross the 128-row q and key tiles of the bf16 TMA body (d
# 64/128), 1000 and 4095 wrap its ring of 2 (d 128) or 3 (d 64) stages
FLASH_SEQS = [(True, 1), (True, 70), (True, 128), (False, 100), (True, 129),
              (False, 255), (True, 1000), (True, 4095)]
# the head-blocked grid stops at S 500 (4 key tiles, past either ring):
# every G of it must fit the 4 MiB budget fwd_bh_block keeps, S <= 512 at
# d_head 128, f32, G 8
BH_SEQS = FLASH_SEQS[:6] + [(True, 500)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 1), (8, 2)])
@pytest.mark.parametrize("causal,seq", FLASH_SEQS)
def test_flash_kernel_matches_plain(device, dtype, d, heads, kv_heads,
                                    causal, seq):
    check_flash_kernel(device, dtype, d, heads, kv_heads, causal, seq)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,seq", FLASH_SEQS)
def test_flash_kernel_gqa_group_4_matches_plain(device, dtype, causal, seq):
    """The 7b heads: H 32 over Hkv 8 at d_head 128."""
    check_flash_kernel(device, dtype, 128, 32, 8, causal, seq)


def check_flash_kernel(device, dtype, d, heads, kv_heads, causal, seq):
    generator = torch.Generator(device=device).manual_seed(d * 1000 + seq)
    q = normal(generator, (2, seq, heads, d), dtype)
    k = normal(generator, (2, seq, kv_heads, d), dtype)
    v = normal(generator, (2, seq, kv_heads, d), dtype)
    variant = "bf16" if dtype == torch.bfloat16 else "f32"
    before = fa.launches[variant]
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    ref, ref_lse = fa.reference_attention(q.float(), k.float(), v.float(),
                                          causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert fa.launches[variant] == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    assert_close_to_plain(out, ref)
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    if dtype == torch.float32:
        assert f32_row_error(out, ref, exact_forward(q, k, v, causal)
                             ) <= FWD_ROW_EXCESS


def exact_forward(q, k, v, causal, scale=None):
    """The plain forward evaluated in f64 on the f32 inputs."""
    return fa.reference_attention(q.double(), k.double(), v.double(),
                                  causal=causal, scale=scale)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("heads,kv_heads,g", [(8, 2, 1), (8, 8, 4)])
def test_flash_forward_f32_large_scores_hold_the_measure(device, d, heads,
                                                         kv_heads, g):
    """q x 4, causal, ragged S 1000: the per-head kernel under GQA group 4
    and the head-blocked kernel at G 4 hold the f64 measure."""
    generator = torch.Generator(device=device).manual_seed(d + heads + g)
    q = normal(generator, (2, 1000, heads, d), torch.float32) * 4.0
    k, v = (normal(generator, (2, 1000, kv_heads, d), torch.float32)
            for _ in range(2))
    variant = "bh_f32" if g > 1 else "f32"
    before = fa.launches[variant]
    out = fa.flash_attention(q, k, v, causal=True, bh_block=g)
    ref = fa.reference_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches[variant] == before + 1
    assert f32_row_error(out, ref, exact_forward(q, k, v, True)
                         ) <= FWD_ROW_EXCESS


def test_flash_forward_f32_measure_rejects_single_pass_tf32(device):
    """The control: the plain forward with single-pass TF32 matmuls
    (cuBLAS's TF32 mode) fails the f64 measure on the large-score case the
    kernel holds it on."""
    generator = torch.Generator(device=device).manual_seed(64 + 1000)
    q = normal(generator, (2, 1000, 8, 64), torch.float32) * 4.0
    k, v = (normal(generator, (2, 1000, 2, 64), torch.float32)
            for _ in range(2))
    out = fa.flash_attention(q, k, v, causal=True)
    ref = fa.reference_attention(q, k, v, causal=True)
    exact = exact_forward(q, k, v, True)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = fa.reference_attention(q, k, v, causal=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert f32_row_error(out, ref, exact) <= FWD_ROW_EXCESS
    assert f32_row_error(tf32, ref, exact) > FWD_ROW_EXCESS


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("batch,heads,g", [(2, 4, 2), (2, 4, 4), (2, 6, 4),
                                           (3, 8, 8), (1, 3, 3)])
@pytest.mark.parametrize("causal,seq", BH_SEQS)
def test_head_blocked_kernel_matches_plain_and_per_head(
        device, dtype, d, batch, heads, g, causal, seq):
    """The head-blocked forward (G b*h rows per CTA; at B 2, H 6, G 4 a
    block straddles two batch elements) against the plain version, and
    bitwise against the per-head kernel, whose per-tile code it runs."""
    generator = torch.Generator(device=device).manual_seed(d * 10 + g + seq)
    q, k, v = (normal(generator, (batch, seq, heads, d), dtype)
               for _ in range(3))
    assert fa.fwd_bh_block(batch * heads, 1, seq, d, dtype, g) == g
    variant = "bf16" if dtype == torch.bfloat16 else "f32"
    before = dict(fa.launches)
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True,
                                  bh_block=g)
    per_head, per_head_lse = fa.flash_attention(q, k, v, causal=causal,
                                                return_lse=True)
    ref, ref_lse = fa.reference_attention(q.float(), k.float(), v.float(),
                                          causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert fa.launches[f"bh_{variant}"] == before[f"bh_{variant}"] + 1
    assert fa.launches[variant] == before[variant] + 1
    assert out.shape == q.shape and out.dtype == dtype
    assert_close_to_plain(out, ref)
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    assert torch.equal(out, per_head) and torch.equal(lse, per_head_lse)
    if dtype == torch.float32:
        assert f32_row_error(out, ref, exact_forward(q, k, v, causal)
                             ) <= FWD_ROW_EXCESS


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch,seq,heads,kv_heads,d", [
    (16, 1024, 32, 8, 128), (64, 1024, 8, 8, 64)])
def test_flash_kernel_causal_grid_fills_the_card(device, dtype, batch, seq,
                                                 heads, kv_heads, d):
    """Causal over B*H 512 rows of S 1024: 4096 CTAs of 128 q rows in bf16
    (the TMA body's heaviest-first order over many waves). Per-head against
    the plain version and, under MHA, the head-blocked kernel at G 4
    bitwise against the per-head one."""
    generator = torch.Generator(device=device).manual_seed(seq + d)
    variant = "bf16" if dtype == torch.bfloat16 else "f32"
    q = normal(generator, (batch, seq, heads, d), dtype)
    k = normal(generator, (batch, seq, kv_heads, d), dtype)
    v = normal(generator, (batch, seq, kv_heads, d), dtype)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    for b in range(0, batch, 8):                # plain version in chunks
        ref, ref_lse = fa.reference_attention(
            q[b:b + 8].float(), k[b:b + 8].float(), v[b:b + 8].float(),
            causal=True, return_lse=True)
        assert_close_to_plain(out[b:b + 8], ref)
        rows = slice(b * heads, (b + 8) * heads)
        assert (lse[rows] - ref_lse).abs().max().item() <= LSE_TOL
    if kv_heads == heads:
        before = fa.launches[f"bh_{variant}"]
        blocked, blocked_lse = fa.flash_attention(
            q, k, v, causal=True, return_lse=True, bh_block=4)
        torch.cuda.synchronize()
        assert fa.launches[f"bh_{variant}"] == before + 1
        assert torch.equal(blocked, out) and torch.equal(blocked_lse, lse)


@pytest.mark.parametrize("scale", [0.25, 0.3])
def test_head_blocked_kernel_explicit_scale(device, scale):
    generator = torch.Generator(device=device).manual_seed(9)
    q, k, v = (normal(generator, (2, 96, 4, 64), torch.float32)
               for _ in range(3))
    out, lse = fa.flash_attention(q, k, v, causal=False, scale=scale,
                                  return_lse=True, bh_block=4)
    ref, ref_lse = fa.reference_attention(q, k, v, causal=False, scale=scale,
                                          return_lse=True)
    torch.cuda.synchronize()
    assert_close_to_plain(out, ref)
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


def test_head_blocked_autograd_on_the_card_matches_the_cpu(device):
    """The backward kernels read the head-blocked forward's LSE."""
    generator = torch.Generator().manual_seed(4)
    q, k, v, weight = (torch.randn((2, 80, 4, 32), generator=generator)
                       for _ in range(4))
    grads = []
    for where in ("cpu", device):
        leaves = [t.to(where).requires_grad_() for t in (q, k, v)]
        before = fa.launches["bh_f32"]
        loss = (fa.flash_attention(*leaves, causal=False, bh_block=4)
                * weight.to(where)).sum()
        grads.append([g.cpu() for g in torch.autograd.grad(loss, leaves)])
        assert fa.launches["bh_f32"] == before + (where != "cpu")
    for card, cpu in zip(grads[1], grads[0]):
        assert grad_row_error(card, cpu) <= CARD_VS_CPU_TOL


# S 129, 200 and 255 cross the 128-row resident and 64/128-row streamed
# tiles of the bf16 TMA body (d 64/128); 1000 and 4095 wrap its ring of 4
# stages, 4095 with a ragged last tile
BACKWARD_SEQS = [(True, 1), (True, 70), (True, 128), (False, 100),
                 (True, 200), (False, 255), (True, 1000), (False, 1000),
                 (True, 4095)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2), (8, 2), (8, 1)])
@pytest.mark.parametrize("causal,seq", BACKWARD_SEQS)
def test_flash_backward_kernel_matches_plain(device, dtype, d, heads,
                                             kv_heads, causal, seq):
    """dq/dk/dv of both backward kernels (dQ, dK/dV) at every head dim and
    GQA group 1-8, causal or not, S ragged against the tiles."""
    check_flash_backward(device, dtype, d, 2, heads, kv_heads, causal, seq)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,seq", BACKWARD_SEQS)
def test_flash_backward_kernel_gqa_group_4_matches_plain(device, dtype,
                                                         causal, seq):
    """The 7b heads: H 32 over Hkv 8 at d_head 128 (dK/dV sum 4 heads)."""
    check_flash_backward(device, dtype, 128, 1, 32, 8, causal, seq)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch,seq,heads,kv_heads,d", [
    (16, 1024, 32, 8, 128), (64, 1024, 8, 8, 64)])
def test_flash_backward_causal_grid_fills_the_card(device, dtype, batch, seq,
                                                   heads, kv_heads, d):
    """Causal over B*H 512 rows of S 1024: 4096 dQ CTAs and 1024 or 4096
    dK/dV CTAs of 128 rows in bf16, many waves of the heaviest-first
    order; the plain version in batch chunks."""
    check_flash_backward(device, dtype, d, batch, heads, kv_heads, True, seq,
                         chunk=8)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_f32_large_scores_matches_plain(device, d):
    """f32 with q scaled x4: scores of std about 4, where an error in S
    grows through exp, and rows whose softmax saturates cancel — the kernel
    must still hold the f32 measure. Causal, ragged S 1000, a GQA group of
    4."""
    check_flash_backward(device, torch.float32, d, 2, 8, 2, True, 1000,
                         q_scale=4.0)


def test_flash_backward_f32_measure_rejects_single_pass_tf32(device):
    """The control: the plain backward with single-pass TF32 matmuls
    (cuBLAS's TF32 mode) fails the f32 measure on the large-score case the
    kernel holds it on."""
    generator = torch.Generator(device=device).manual_seed(64 * 100 + 1000)
    q = normal(generator, (2, 1000, 8, 64), torch.float32) * 4.0
    k, v = (normal(generator, (2, 1000, 2, 64), torch.float32)
            for _ in range(2))
    do = normal(generator, (2, 1000, 8, 64), torch.float32)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    inputs = (q, k, v, out, lse, do)
    refs = fa.flash_attention_backward_reference(*inputs, causal=True)
    exact = exact_backward(*inputs, True)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = fa.flash_attention_backward_reference(*inputs, causal=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    worst = max(f32_row_error(g, r, e, name == "q")
                for g, r, e, name in zip(tf32, refs, exact, "qkv"))
    assert worst > GRAD_ROW_TOL[torch.float32]


def check_flash_backward(device, dtype, d, batch, heads, kv_heads, causal,
                         seq, chunk=None, q_scale=1.0):
    generator = torch.Generator(device=device).manual_seed(d * 100 + seq)
    q = normal(generator, (batch, seq, heads, d), dtype) * q_scale
    k = normal(generator, (batch, seq, kv_heads, d), dtype)
    v = normal(generator, (batch, seq, kv_heads, d), dtype)
    do = normal(generator, (batch, seq, heads, d), dtype)
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    variant = "bwd_bf16" if dtype == torch.bfloat16 else "bwd_f32"
    before = fa.launches[variant]
    grads = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches[variant] == before + 1
    chunk = chunk or batch
    lse = lse.reshape(batch, heads, 1, seq)
    for b in range(0, batch, chunk):            # plain version in chunks
        rows = slice(b, b + chunk)
        n = q[rows].shape[0]
        inputs = (q[rows], k[rows], v[rows], out[rows],
                  lse[rows].reshape(n * heads, 1, seq), do[rows])
        refs = fa.flash_attention_backward_reference(*inputs, causal=causal)
        exact = (exact_backward(*inputs, causal)
                 if dtype == torch.float32 else refs)
        for grad, ref, ex, like, name in zip(grads, refs, exact, (q, k, v),
                                             "qkv"):
            assert grad.shape == like.shape and grad.dtype == dtype, name
            grad = grad[rows]
            assert bool(torch.isfinite(grad).all()), name
            if seq == 1 and name != "v":      # zero in exact arithmetic
                assert (grad.float() - ref.float()).abs().max().item() \
                    <= ZERO_GRAD_ABS, name
                continue
            first = causal and name == "q"
            error = (f32_row_error(grad, ref, ex, first)
                     if dtype == torch.float32
                     else grad_row_error(grad, ref, first_row_zero=first))
            assert error <= GRAD_ROW_TOL[dtype], (name, error)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("causal,seq", [(True, 1000), (False, 255)])
def test_flash_backward_kernel_is_bitwise_reproducible(device, dtype, d,
                                                       causal, seq):
    """Two launches on one input give the same dq, dk and dv bit for bit:
    every sum runs in a fixed order (no atomics), over a GQA group of 4."""
    generator = torch.Generator(device=device).manual_seed(d + seq)
    q, do = (normal(generator, (2, seq, 8, d), dtype) for _ in range(2))
    k, v = (normal(generator, (2, seq, 2, d), dtype) for _ in range(2))
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    first = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    second = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, "qkv"):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [0.25, 0.3])
def test_flash_backward_kernel_explicit_scale_and_delta(device, scale, dtype):
    """Ring attention's call: non-causal, its own scale (a power of two is
    folded into q by the JAX rule, 0.3 stays on the scores) and a delta
    computed beforehand; bf16 runs the TMA body."""
    generator = torch.Generator(device=device).manual_seed(5)
    q, do = (normal(generator, (1, 96, 4, 64), dtype) for _ in range(2))
    k, v = (normal(generator, (1, 96, 2, 64), dtype) for _ in range(2))
    out, lse = fa.flash_attention(q, k, v, causal=False, scale=scale,
                                  return_lse=True)
    delta = fa.flash_bwd_delta(do, out)
    grads = fa.flash_attention_backward(q, k, v, out, lse, do, causal=False,
                                        scale=scale, delta=delta)
    refs = fa.flash_attention_backward_reference(
        q, k, v, out, lse, do, causal=False, scale=scale, delta=delta)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        exact = exact_backward(q, k, v, out, lse, do, False, scale, delta)
        for grad, ref, ex in zip(grads, refs, exact):
            assert f32_row_error(grad, ref, ex) <= GRAD_ROW_TOL[dtype]
        return
    for grad, ref in zip(grads, refs):
        assert grad_row_error(grad, ref) <= GRAD_ROW_TOL[dtype]


def test_flash_autograd_on_the_card_matches_the_cpu(device):
    """torch.autograd through flash_attention: the forward and backward
    kernels on the card against the plain versions on the CPU, f32."""
    generator = torch.Generator().manual_seed(2)
    q = torch.randn((2, 80, 8, 32), generator=generator)
    k = torch.randn((2, 80, 2, 32), generator=generator)
    v = torch.randn((2, 80, 2, 32), generator=generator)
    weight = torch.randn((2, 80, 8, 32), generator=generator)
    grads = []
    for where in ("cpu", device):
        leaves = [t.to(where).requires_grad_() for t in (q, k, v)]
        loss = (fa.flash_attention(*leaves, causal=True)
                * weight.to(where)).sum()
        grads.append([g.cpu() for g in torch.autograd.grad(loss, leaves)])
    for card, cpu, name in zip(grads[1], grads[0], "qkv"):
        assert grad_row_error(card, cpu, first_row_zero=name == "q") \
            <= CARD_VS_CPU_TOL


PAGED_VARIANTS = ["bf16", "f32", "int8", "int8/bf16q"]
PAGED_GROUPS = [(4, 4), (4, 2), (8, 2), (8, 1)]       # group 1, 2, 4, 8


def paged_inputs(device, generator, rng, variant, d, heads, kv_heads,
                 page_size, positions, max_pages, parked=(0,), poisoned=(),
                 spare=3):
    """q, pages, page table and positions over a shuffled pool (page 0 =
    trash): each slot's live pages (none for a parked slot, whose row is
    all trash), then, for a ``poisoned`` slot, one entry >= P right past
    its live window; ``variant`` is the page type (``int8/bf16q``: int8
    pages under a bf16 query)."""
    live = [0 if slot in parked else pos // page_size + 1
            for slot, pos in enumerate(positions)]
    num_pages = 1 + sum(live) + spare
    physical = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((len(positions), max_pages), np.int32)
    cursor = 0
    for slot, count in enumerate(live):
        table[slot, :count] = physical[cursor:cursor + count]
        cursor += count
        if slot in poisoned and count < max_pages:
            table[slot, count] = num_pages + 5
    quant = variant.startswith("int8")
    q_dtype = (torch.float32 if variant in ("f32", "int8")
               else torch.bfloat16)
    shape = (num_pages, page_size, kv_heads, d)
    q = normal(generator, (len(positions), 1, heads, d), q_dtype)
    scales = {}
    if quant:
        k_pages = torch.randint(-127, 128, shape, generator=generator,
                                device=device, dtype=torch.int8)
        v_pages = torch.randint(-127, 128, shape, generator=generator,
                                device=device, dtype=torch.int8)
        for name in ("k_scales", "v_scales"):
            scales[name] = 0.005 + 0.015 * torch.rand(
                (num_pages, kv_heads), generator=generator, device=device)
    else:
        k_pages = normal(generator, shape, q_dtype)
        v_pages = normal(generator, shape, q_dtype)
    page_table = torch.from_numpy(table).to(device)
    pos = torch.tensor(positions, dtype=torch.int32, device=device)
    return q, k_pages, v_pages, page_table, pos, scales


def check_paged(variant, q, k_pages, v_pages, page_table, pos, scales,
                parked=(0,)):
    """One launch against the plain version (f32 on the same values; for
    bf16 pages also the plain version on the bf16 values themselves, which
    rounds P to bf16 as the JAX function does); parked slots only finite."""
    key = variant.split("/")[0]
    before = pa.launches[key]
    out = pa.paged_attention(q, k_pages, v_pages, page_table, pos, **scales)
    plain_pages = ((k_pages, v_pages) if k_pages.dtype == torch.int8
                   else (k_pages.float(), v_pages.float()))
    # the plain gather reads every entry: ids >= P (past the windows, where
    # the kernel reads nothing) become the trash page there
    plain_table = torch.where(page_table < k_pages.shape[0], page_table, 0)
    ref = pa.paged_attention_reference(q.float(), *plain_pages, plain_table,
                                       pos, scales.get("k_scales"),
                                       scales.get("v_scales"))
    torch.cuda.synchronize()
    assert pa.launches[key] == before + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    assert bool(torch.isfinite(out).all())
    live = [s for s in range(q.shape[0]) if s not in parked]
    assert_close_to_plain(out[live], ref[live])
    if k_pages.dtype == torch.bfloat16:
        ref = pa.paged_attention_reference(q, k_pages, v_pages,
                                           plain_table, pos)
        assert_close_to_plain(out[live], ref[live].float())
    return out


@pytest.mark.parametrize("variant", PAGED_VARIANTS)
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("heads,kv_heads", PAGED_GROUPS)
@pytest.mark.parametrize("page_size", [8, 16])
def test_paged_kernel_matches_plain(device, variant, d, heads, kv_heads,
                                    page_size):
    """Five slots over a shuffled pool: a parked slot (position 0, trash
    row), positions at both sides of a page boundary, one mid-page and one
    at the last position of a 4-page window."""
    generator = torch.Generator(device=device).manual_seed(d + heads)
    max_pages = 4
    positions = [0, page_size - 1, page_size, 3 * page_size + 2,
                 max_pages * page_size - 1]
    check_paged(variant, *paged_inputs(
        device, generator, np.random.default_rng(d), variant, d, heads,
        kv_heads, page_size, positions, max_pages))


@pytest.mark.parametrize("variant", PAGED_VARIANTS)
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("heads,kv_heads", PAGED_GROUPS)
@pytest.mark.parametrize("page_size,max_pages", [(8, 64), (16, 64),
                                                 (8, 256), (16, 256)])
def test_paged_kernel_long_context_matches_plain(device, variant, d, heads,
                                                 kv_heads, page_size,
                                                 max_pages):
    """Contexts over many 256-token chunks of the split: positions at the
    chunk edges +-1, a slot inside the first chunk only, the parked slot,
    the last position of the window, and entries >= P right past two
    slots' live pages (never read)."""
    generator = torch.Generator(device=device).manual_seed(
        d + heads + max_pages)
    window = max_pages * page_size
    edges = [255, 256, 257, 511, 512, 513, 1023, 1024]
    positions = ([0, 100] + [e for e in edges if e < window - 1]
                 + [window - 1, window // 2 + 1])
    check_paged(variant, *paged_inputs(
        device, generator, np.random.default_rng(d + max_pages), variant, d,
        heads, kv_heads, page_size, positions, max_pages, poisoned=(1, 4)))


@pytest.mark.parametrize("variant", PAGED_VARIANTS)
def test_paged_kernel_is_bitwise_reproducible(device, variant):
    """Two launches on the same inputs give the same bits: the merge
    tickets reset and the merge sums the chunks in a fixed order."""
    generator = torch.Generator(device=device).manual_seed(3)
    inputs = paged_inputs(device, generator, np.random.default_rng(3),
                          variant, 128, 32, 8, 16,
                          [4095, 2999, 1499, 299, 16, 15, 0, 2047], 256,
                          parked=(6,))
    first = check_paged(variant, *inputs, parked=(6,))
    second = check_paged(variant, *inputs, parked=(6,))
    assert torch.equal(first, second)


@pytest.mark.parametrize("variant", PAGED_VARIANTS)
def test_paged_kernel_replays_in_a_cuda_graph(device, variant):
    """One call captured in a CUDA graph, replayed after the contents of
    positions and the page table changed, matches the plain version on the
    new contents: the grid does not depend on positions."""
    generator = torch.Generator(device=device).manual_seed(5)
    max_pages, page_size, slots = 32, 16, 4
    rng = np.random.default_rng(5)
    positions = [511, 40, 0, 300]
    q, k_pages, v_pages, page_table, pos, scales = paged_inputs(
        device, generator, rng, variant, 64, 8, 2, page_size, positions,
        max_pages, parked=(2,), spare=40)
    pa.paged_attention(q, k_pages, v_pages, page_table, pos, **scales)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_attention(q, k_pages, v_pages, page_table, pos,
                                 **scales)
    new_positions = [17, 300, 511, 0]
    table = np.zeros((slots, max_pages), np.int32)
    physical = rng.permutation(np.arange(1, k_pages.shape[0]))
    cursor = 0
    for slot, position in enumerate(new_positions[:3]):
        count = position // page_size + 1
        table[slot, :count] = physical[cursor:cursor + count]
        cursor += count
    page_table.copy_(torch.from_numpy(table))
    pos.copy_(torch.tensor(new_positions, dtype=torch.int32))
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        plain_pages = ((k_pages, v_pages) if k_pages.dtype == torch.int8
                       else (k_pages.float(), v_pages.float()))
        ref = pa.paged_attention_reference(
            q.float(), *plain_pages, page_table, pos,
            scales.get("k_scales"), scales.get("v_scales"))
        assert bool(torch.isfinite(out).all())
        assert_close_to_plain(out[:3], ref[:3])


def test_wrappers_refuse_what_the_kernels_do_not_take(device):
    generator = torch.Generator(device=device).manual_seed(0)
    q = normal(generator, (1, 8, 4, 48), torch.float32)
    with pytest.raises(ValueError, match="d_head"):
        fa.flash_attention(q, q, q)
    q = normal(generator, (1, 8, 4, 16), torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           q, q)
    pages = normal(generator, (3, 8, 1, 16), torch.float32)
    table = torch.zeros((2, 2), dtype=torch.int32, device=device)
    pos = torch.zeros(2, dtype=torch.int32, device=device)
    q = normal(generator, (2, 1, 3, 16), torch.float32)      # group 3
    with pytest.raises(ValueError, match="query heads per kv head"):
        pa.paged_attention(q, pages, pages, table, pos)
    q = normal(generator, (2, 1, 4, 16), torch.float32)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(q, pages, pages, table.long(), pos)
    with pytest.raises(ValueError, match="scales"):
        pa.paged_attention(q, pages.to(torch.int8), pages.to(torch.int8),
                           table, pos)
    shifted = torch.zeros(pages.numel() + 1, device=device)[1:].view(
        pages.shape)                  # contiguous, 4 bytes off 16
    with pytest.raises(ValueError, match="aligned"):
        pa.paged_attention(q, shifted, shifted, table, pos)


def test_prefetch_to_the_card(device, tmp_path):
    """Batches copied on the side stream arrive whole: each equals
    batch_at(step) when the consumer's stream reads it."""
    from tensorhive_tpu_torch import data

    pattern = data.fake_shards(tmp_path, tokens_per_shard=1 << 16)
    dataset = data.TokenDataset(data.DataConfig(pattern=pattern,
                                                seq_len=1023, batch_size=16))
    batches = list(data.prefetch_to_device(dataset, 3, 6, device=device))
    assert len(batches) == 6
    for step, batch in zip(range(3, 9), batches):
        assert batch.device.type == "cuda" and batch.shape == (16, 1024)
        assert torch.equal(batch.cpu(), torch.from_numpy(
            dataset.batch_at(step)))


@pytest.mark.parametrize("speculative", ["off", "on"])
@pytest.mark.parametrize("kv_quant", ["off", "on"])
def test_tiny_engine_on_the_card_matches_the_cpu(device, kv_quant,
                                                 speculative):
    """The f32 tiny engine emits the tokens its plain CPU twin emits on the
    same params: with whole-prompt prefill through both kernels (d_head 16,
    MHA), and with the default prefix cache, whose chunked prefill attends
    in plain f32 and whose decode runs the paged kernel. With the
    speculative lane on, the draft steps run the paged kernel, the draft
    prefill mirrors the flash kernel, and the proposal counters agree
    too."""
    from tensorhive_tpu_torch.convert import params_from_jax, params_to_numpy
    from tensorhive_tpu_torch.models.transformer import PRESETS, TransformerLM
    from tensorhive_tpu_torch.serving.engine import SlotEngine

    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                                 max_seq_len=128)
    params = TransformerLM.init(config, torch.Generator().manual_seed(0),
                                device="cpu")
    on_card = params_from_jax(params_to_numpy(params), config, device)
    prompts = [list(range(3, 11)), [5], list(range(1, 41)), [9, 8, 7]]
    for prefix_cache in ("off", "auto"):
        results = []
        for device_params, where in ((params, "cpu"), (on_card, device)):
            engine = SlotEngine(device_params, config, slots=4, max_len=96,
                                kv_quant=kv_quant, prefix_cache=prefix_cache,
                                prefill_chunk_tokens=16,
                                speculative=speculative, device=where)
            engine.warmup(prompt_lens=(16, 48))
            handles = []
            for prompt in prompts + [list(range(1, 41)) + [7, 7]]:
                handles.append(engine.submit(prompt, max_new_tokens=8))
                engine.step()
            engine.pump()
            results.append(([h.result(timeout_s=30)["tokens"]
                             for h in handles],
                            engine.spec_proposed, engine.spec_accepted,
                            engine.steps, engine.draft_dispatches))
        assert results[0] == results[1], prefix_cache


def test_tier_copies_on_the_copy_stream_are_byte_exact(device):
    """The host tier's copies on the card: pages gathered on the compute
    stream go out to pinned host memory on the engine's copy stream, on the
    lane's thread, and come back into other pages the same way, byte for
    byte (payload and scales). Meanwhile the compute stream keeps writing:
    other pages, and the gathered pages themselves right after the gather,
    which the copy out must not see (stream order); the pages under
    transfer back are not touched by it."""
    import threading

    from tensorhive_tpu_torch.models.transformer import PRESETS, TransformerLM
    from tensorhive_tpu_torch.serving.engine import SlotEngine
    from tensorhive_tpu_torch.serving.paging import HostPageEntry

    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                                 max_seq_len=128)
    params = TransformerLM.init(config, device=device)
    engine = SlotEngine(params, config, slots=2, max_len=64, page_size=4,
                        kv_pages=48, host_kv_bytes=1 << 20,
                        speculative="off", device=device)
    compute = torch.cuda.current_stream()
    assert engine._copy_stream is not None
    assert engine._copy_stream.cuda_stream != compute.cuda_stream
    generator = torch.Generator(device=device).manual_seed(3)
    for tensor in engine._cache:
        if tensor.dtype == torch.int8:
            tensor.copy_(torch.randint(-127, 128, tensor.shape,
                                       generator=generator, device=device))
        else:
            tensor.copy_(torch.rand(tensor.shape, generator=generator,
                                    device=device))
    source, busy, target = [3, 7, 9, 11], list(range(20, 30)), [31, 35, 40, 44]
    before = [tensor[:, source].clone() for tensor in engine._cache]
    filler = torch.randn(4096, 4096, device=device)

    def on_lane(fn):
        out = {}
        thread = threading.Thread(target=lambda: out.update(result=fn()))
        thread.start()
        return thread, out

    extracted, ready = engine._dispatch_page_extract(source)
    thread, out = on_lane(lambda: engine._materialize_demotion(
        [b"%d" % page for page in source], extracted, ready))
    for step in range(20):                 # the compute stream stays busy
        torch.matmul(filler, filler)
        for tensor in engine._cache:
            tensor[:, busy] = step
            tensor[:, source] = 0
    thread.join(timeout=60)
    assert not thread.is_alive()
    _, pages = out["result"]
    for index, page in enumerate(pages):
        for got, then in zip(page, before):
            assert torch.equal(torch.from_numpy(got), then[:, index].cpu())

    thread, out = on_lane(lambda: engine._stage_promotion(
        [HostPageEntry(*page, last_used=0) for page in pages]))
    for step in range(20):
        torch.matmul(filler, filler)
        for tensor in engine._cache:
            tensor[:, busy] = step
    thread.join(timeout=60)
    assert not thread.is_alive()
    engine._dispatch_page_inject(target, out["result"])
    torch.cuda.synchronize()
    for tensor, then in zip(engine._cache, before):
        assert torch.equal(tensor[:, target], then)
        assert bool((tensor[:, busy] == 19).all())
        assert not tensor[:, source].any()


def test_tiny_tiered_engine_on_the_card_matches_the_cpu(device):
    """The tiered tiny engine (page 4, 12 pages, 1 MiB of host RAM) on the
    card, on the real threaded copy lane, against its CPU twin: a miss, an
    HBM hit, two requests that evict the first prompt to the host, a host
    hit and a repeat give the same tokens and the same tier counters, with
    no recompute fallback; on the card the four runs of the first prompt
    give one stream. The speculative lane is off: on int8 pages its
    rejected window writes raise page scales, so tokens there depend on
    the proposals, and the draft lane is not tiered (ROADMAP C)."""
    from tensorhive_tpu_torch.convert import params_from_jax, params_to_numpy
    from tensorhive_tpu_torch.models.transformer import PRESETS, TransformerLM
    from tensorhive_tpu_torch.serving.engine import SlotEngine

    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                                 max_seq_len=128)
    params = TransformerLM.init(config, torch.Generator().manual_seed(0),
                                device="cpu")
    on_card = params_from_jax(params_to_numpy(params), config, device)
    prompt_a = list(range(3, 27))
    schedule = [prompt_a, prompt_a, list(range(40, 64)), list(range(70, 94)),
                prompt_a, prompt_a]
    results = []
    for device_params, where in ((params, "cpu"), (on_card, device)):
        engine = SlotEngine(device_params, config, slots=2, max_len=64,
                            page_size=4, kv_pages=12, prefix_min_tokens=4,
                            host_kv_bytes=1 << 20, speculative="off",
                            device=where)
        engine.warmup(prompt_lens=(24,))
        tokens = []
        for prompt in schedule:
            handle = engine.submit(prompt, max_new_tokens=6)
            engine.pump()
            tokens.append(handle.result(timeout_s=30)["tokens"])
        stats = engine.stats()
        results.append((tokens, engine.host_kv_hits, engine.host_kv_misses,
                        engine.host_kv_demotions, engine.host_kv_promotions,
                        engine.host_kv_fallbacks, stats["hostPagesResident"],
                        stats["kvPagesFree"], stats["cachedPages"]))
    assert results[0] == results[1]
    tokens = results[1][0]
    assert tokens[0] == tokens[1] == tokens[4] == tokens[5]
    assert results[1][4] == 5 and results[1][5] == 0


def test_tiered_engine_under_the_daemon_thread(device, tmp_path):
    """The same tiered tiny engine pumped by ``GenerationService`` on its
    own thread (CUDA's current device and stream are per thread: the
    engine records its events on the pump thread's current stream, which
    the copy lane waits on). The host hit promotes A's 5 pages and gives
    the HBM hit's tokens, and the crash-free run leaves the ledger one
    completed row per request."""
    from tensorhive_tpu_torch.config import Config, GenerationConfig
    from tensorhive_tpu_torch.core.services.generation import (
        GenerationService,
    )
    from tensorhive_tpu_torch.models.transformer import PRESETS, TransformerLM
    from tensorhive_tpu_torch.observability import get_request_ledger
    from tensorhive_tpu_torch.serving.engine import SlotEngine

    model = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                                max_seq_len=128)
    params = TransformerLM.init(model, device=device)

    def factory():
        engine = SlotEngine(params, model, slots=2, max_len=64, page_size=4,
                            kv_pages=12, prefix_min_tokens=4,
                            host_kv_bytes=1 << 20, speculative="off",
                            device=device)
        engine.warmup(prompt_lens=(24,))
        return engine

    config = Config(config_dir=tmp_path)
    config.generation = GenerationConfig(interval_s=0.02)
    service = GenerationService(config, engine=factory(),
                                engine_factory=factory)
    ledger = get_request_ledger()
    ledger.clear()
    prompt_a = list(range(3, 27))
    schedule = [prompt_a, prompt_a, list(range(40, 64)),
                list(range(70, 94)), prompt_a]
    service.start()
    try:
        tokens = []
        for prompt in schedule:
            handle = service.engine.submit(prompt, max_new_tokens=6)
            tokens.append(handle.result(timeout_s=60)["tokens"])
    finally:
        service.shutdown()
        service.join(timeout=30)
    assert not service.is_alive()
    engine = service.engine
    assert tokens[4] == tokens[1] == tokens[0]
    assert engine.host_kv_hits >= 1 and engine.host_kv_promotions >= 5
    assert engine.host_kv_fallbacks == 0
    rows = ledger.recent()
    assert [row["outcome"] for row in rows] == ["completed"] * 5
    assert rows[0]["hostHitPages"] == 5
