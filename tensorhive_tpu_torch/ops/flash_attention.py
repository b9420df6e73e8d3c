"""Flash attention, forward and backward — the PyTorch + CUDA counterpart
of ``tensorhive_tpu/ops/flash_attention.py``.

``flash_attention`` launches the hand-written kernel ``csrc/flash_fwd.cu``
for CUDA tensors and runs its plain PyTorch version,
``reference_attention``, for CPU tensors — at any sequence length: the
JAX dispatch falls back to the reference when S does not divide the block
(a 3000-token prompt pads to the 4095 bucket), the kernel here masks the
ragged tile itself, so a CUDA tensor never reaches the plain version.

It is differentiable through ``_FlashAttention`` (the JAX ``custom_vjp``):
the forward saves q, k, v, O and LSE, and the backward runs
``flash_attention_backward`` — the two kernels of ``csrc/flash_bwd.cu``
(dQ, then dK/dV) for CUDA tensors, the plain
``flash_attention_backward_reference`` for CPU tensors.

``bh_block`` is the JAX package's ``TPUHIVE_FLASH_BH_BLOCK`` as an
argument: the number G of consecutive b·h rows one program covers in the
head-blocked forward (``_fwd_kernel_resident_bh``). ``fwd_bh_block``, a copy
of the JAX ``_fwd_bh_block``, clamps the request as JAX does (to divide
B·H, to fit ``RESIDENT_KV_MAX_BYTES``, and to 1 for GQA); a CUDA call whose
G stays above 1 launches the head-blocked kernel of ``csrc/flash_fwd.cu``,
any other the per-head one. Both compute K1's function, so on CPU tensors
every G runs ``reference_attention``, and the backward reads either one's
LSE.

The kernels take every d_head that is a multiple of 16 from 16 to 256
(``HEAD_DIMS``; a width between the ones a body is built for runs the next
wider body with zero padding), any GQA group and any B·H. A CUDA call at
another width raises, naming that set: JAX's kernels take any width, so
those widths are the one shape the port refuses where JAX runs.

``launches`` counts wrapper launches per direction and input type (one
backward launch runs both backward kernels); the kernel-vs-plain checks
call the plain versions directly and do not count.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple, Union

import torch

from . import cuda_build, launch_counts

NEG_INF = -1e30

#: kernel launches per direction and input type (the main-path counters):
#: "bf16"/"f32" the per-head forward, "bh_bf16"/"bh_f32" the head-blocked
#: forward, "bwd_bf16"/"bwd_f32" the backward
launches: Dict[str, int] = {"bf16": 0, "f32": 0, "bh_bf16": 0, "bh_f32": 0,
                            "bwd_bf16": 0, "bwd_f32": 0}
#: launches by (counter of ``launches``, heads, kv_heads): the head counts
#: a mesh rank launches at
launch_heads: Dict[Tuple[str, int, int], int] = {}
launch_counts.register(launches, launch_heads)


def _count(key: str, heads: int, kv_heads: int) -> None:
    launches[key] += 1
    heads_key = (key, heads, kv_heads)
    launch_heads[heads_key] = launch_heads.get(heads_key, 0) + 1

#: the JAX package's per-operand VMEM budget of its resident kernels, kept
#: here only so that ``fwd_bh_block`` picks the G that JAX picks
RESIDENT_KV_MAX_BYTES = 4 * 1024 * 1024

_DTYPES = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16")}
#: the d_head widths the CUDA kernels take (flash forward and backward, and
#: paged decode): every multiple of 16 from 16 to 256
HEAD_DIMS = tuple(range(16, 257, 16))


def check_head_dim(d: int) -> None:
    """Raise unless the CUDA kernels take d_head ``d`` (``HEAD_DIMS``)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take d_head a multiple of 16 "
                         f"from 16 to 256 ({', '.join(map(str, HEAD_DIMS))}),"
                         f" got {d}")


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        return_lse: bool = False
                        ) -> Union[torch.Tensor,
                                   Tuple[torch.Tensor, torch.Tensor]]:
    """Plain softmax attention with f32 accumulation — the JAX oracle
    term for term (f64 for f64 inputs: the same function evaluated exactly
    enough to measure an f32 version against). q [B, Sq, H, D], k/v [B, Sk,
    Hkv, D]; GQA is expanded here (``repeat_interleave``: head h uses KV
    head h // group). The causal mask is bottom-right aligned (``tril(..,
    Sk - Sq)``). With ``return_lse`` also returns the row log-sum-exp as
    [B*H, 1, Sq] in the accumulation type."""
    if k.shape[2] != q.shape[2]:
        group = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if causal:
        seq_q, seq_k = scores.shape[2], scores.shape[3]
        mask = torch.ones(seq_q, seq_k, dtype=torch.bool,
                          device=q.device).tril(seq_k - seq_q)
        scores.masked_fill_(~mask, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1) if return_lse else None
    probs = torch.softmax(scores, dim=-1)
    del scores
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(acc)).to(q.dtype)
    if not return_lse:
        return out
    batch, heads, seq_q = lse.shape
    return out, lse.reshape(batch * heads, 1, seq_q)


def _library() -> ctypes.CDLL:
    library = cuda_build.load("flash_fwd")
    function = library.thp_flash_fwd
    if function.argtypes is None:
        function.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                             + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                     ctypes.c_void_p])
        function.restype = ctypes.c_int
        blocked = library.thp_flash_fwd_bh
        blocked.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                            + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                    ctypes.c_int,
                                                    ctypes.c_void_p])
        blocked.restype = ctypes.c_int
    return library


def _bwd_library() -> ctypes.CDLL:
    library = cuda_build.load("flash_bwd")
    function = library.thp_flash_bwd
    if function.argtypes is None:
        function.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                             + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                     ctypes.c_void_p])
        function.restype = ctypes.c_int
    return library


def _kv_resident(seq_len: int, d: int, dtype: torch.dtype,
                 factor: int = 1) -> bool:
    """The JAX ``_kv_resident``: one b·h row's K+V (times ``factor``) fit
    ``RESIDENT_KV_MAX_BYTES``."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * factor * seq_len * d * itemsize <= RESIDENT_KV_MAX_BYTES


def fwd_bh_block(bh: int, group: int, seq_len: int, d: int,
                 dtype: torch.dtype, requested: int) -> int:
    """G, the b·h rows per program of the head-blocked forward, for a
    request of ``requested`` — the JAX ``_fwd_bh_block`` with the request
    as an argument instead of ``TPUHIVE_FLASH_BH_BLOCK``: 1 when the
    request is at most 1 or the attention is GQA (``group`` > 1), else the
    largest G <= the request that divides ``bh`` and whose G rows of K+V fit
    the resident budget."""
    if requested <= 1 or group != 1:
        return 1
    g = requested
    while g > 1 and (bh % g or not _kv_resident(seq_len, d, dtype, factor=g)):
        g -= 1
    return g


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q [B,S,H,D] and k/v "
                         f"[B,S,Hkv,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    batch, seq, heads, d = q.shape
    if k.shape[0] != batch or k.shape[1] != seq or k.shape[3] != d:
        raise ValueError("the CUDA kernel needs k/v with q's batch, sequence "
                         "length and head dim (self-attention)")
    if heads % k.shape[2]:
        raise ValueError("heads must be a multiple of kv_heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the CUDA kernel takes bf16 or f32 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    check_head_dim(d)
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous q/k/v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the CUDA kernel loads 16-byte vectors: q/k/v must "
                         "start 16-byte aligned")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, scale: Optional[float], bh_block: int = 1
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE): the plain version for CPU tensors, for CUDA the
    head-blocked kernel when ``fwd_bh_block`` gives G > 1, else the
    per-head kernel."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal, scale=scale,
                                   return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check_inputs(q, k, v)
    batch, seq, heads, d = q.shape
    kv_heads = k.shape[2]
    code, variant = _DTYPES[q.dtype]
    out = torch.empty_like(q)
    lse = torch.empty((batch * heads, 1, seq), dtype=torch.float32,
                      device=q.device)
    if scale is None:
        scale = d ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    g = fwd_bh_block(batch * heads, heads // kv_heads, seq, d, q.dtype,
                     bh_block)
    if g > 1:
        status = _library().thp_flash_fwd_bh(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), batch, seq, heads, d, int(causal), float(scale),
            g, stream)
        cuda_build.check(status, "flash_fwd_bh")
        _count(f"bh_{variant}", heads, kv_heads)
        return out, lse
    status = _library().thp_flash_fwd(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), batch, seq, heads, kv_heads, d, int(causal),
        float(scale), stream)
    cuda_build.check(status, "flash_fwd")
    _count(variant, heads, kv_heads)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """The JAX ``_flash_vjp``: the forward keeps ``(q, k, v, O, LSE)`` as
    ``_flash_vjp_fwd`` does (O in the caller's layout, which lives on as an
    activation anyway), the backward recomputes P from LSE. LSE is an
    output without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float],
                bh_block: int = 1):
        out, lse = _forward(q, k, v, causal, scale, bh_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, grad_out, grad_lse):
        del grad_lse                    # LSE is not differentiated
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, grad_out.contiguous(), causal=ctx.causal,
            scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    return_lse: bool = False, bh_block: int = 1
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Fused attention. q [B, S, H, D]; k, v [B, S, Hkv, D] with
    H % Hkv == 0 (GQA native: no expanded K/V copy). Returns O [B, S, H, D]
    in q's dtype and, with ``return_lse``, LSE [B*H, 1, S] f32.
    Differentiable in q, k and v through the flash backward. ``bh_block``
    requests the head-blocked forward over that many b·h rows per program
    (``fwd_bh_block`` clamps it; 1 = the per-head forward).

    CPU tensors run the plain versions; CUDA tensors launch the kernels or
    raise — there is no fallback."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = _FlashAttention.apply(q, k, v, causal, scale, bh_block)
    else:
        out, lse = _forward(q, k, v, causal, scale, bh_block)
    return (out, lse) if return_lse else out


# -- backward -----------------------------------------------------------------

def _fold_scale_into_q(q: torch.Tensor, scale: float
                       ) -> Tuple[torch.Tensor, float]:
    """The JAX rule (``_fold_scale_into_q``): fold the scale into q only
    when that is exact in q's dtype — a power of two — and return the
    residual left to multiply the f32 scores by."""
    if scale == 1.0:
        return q, 1.0
    if math.frexp(abs(scale))[0] == 0.5:    # mantissa 1/2 <=> power of two
        return q * scale, 1.0
    return q, scale


def flash_bwd_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) as [B*H, 1, S] f32, from dO and O in
    [B, S, H, D] — the JAX ``flash_bwd_delta``, which XLA computes outside
    the kernels; ring attention computes it once per backward."""
    batch, seq, heads, _ = do.shape
    delta = (do.to(torch.float32) * out.to(torch.float32)).sum(-1)
    return delta.permute(0, 2, 1).reshape(batch * heads, 1, seq).contiguous()


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
        scale: Optional[float] = None, delta: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain FA-2 backward, term for term the JAX ``_bwd_probs_ds`` and the
    dq/dkv kernels over the whole score matrix: P = exp(S - LSE) with
    masked scores at NEG_INF, dS = P * (dO V^T - delta), dV = P^T dO,
    dK = scale * dS^T Q, dQ = scale * dS K. Products take the input type's
    values with f32 accumulation (f64 for f64 inputs: the same function
    evaluated exactly enough to measure an f32 version against); P and dS
    are rounded to the input type before their products, as the JAX
    kernels' ``.astype`` do. GQA: dK/dV sum over the ``group`` query heads
    of each KV head. Returns (dq, dk, dv) in the layouts and types of q, k
    and v."""
    batch, seq, heads, d = q.shape
    kv_heads = k.shape[2]
    group = heads // kv_heads
    if scale is None:
        scale = d ** -0.5
    if delta is None:
        delta = flash_bwd_delta(do, out)
    acc = torch.promote_types(q.dtype, torch.float32)
    if group > 1:
        k_heads = k.repeat_interleave(group, dim=2)
        v_heads = v.repeat_interleave(group, dim=2)
    else:
        k_heads, v_heads = k, v
    q_folded, residual = _fold_scale_into_q(q, scale)
    scores = torch.einsum("bqhd,bkhd->bhqk", q_folded.to(acc),
                          k_heads.to(acc))
    if residual != 1.0:
        scores.mul_(residual)
    if causal:
        mask = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
        scores.masked_fill_(~mask, NEG_INF)
    probs = scores.sub_(lse.reshape(batch, heads, seq, 1)).exp_()
    del scores
    ds = torch.einsum("bqhd,bkhd->bhqk", do.to(acc), v_heads.to(acc))
    ds.sub_(delta.reshape(batch, heads, seq, 1)).mul_(probs)
    dv = torch.einsum("bhqk,bqhd->bkhd", probs.to(do.dtype).to(acc),
                      do.to(acc))
    del probs
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).to(acc),
                      q.to(acc)) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).to(acc),
                      k_heads.to(acc)) * scale
    del ds
    if group > 1:
        dk = dk.reshape(batch, seq, kv_heads, group, d).sum(3)
        dv = dv.reshape(batch, seq, kv_heads, group, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_backward_inputs(q, out, lse, do, delta) -> None:
    batch, seq, heads, _ = q.shape
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out and dO must have q's shape {tuple(q.shape)}, "
                         f"got {tuple(out.shape)}, {tuple(do.shape)}")
    if do.dtype != q.dtype:
        raise ValueError(f"the CUDA kernel takes dO in q's dtype {q.dtype}, "
                         f"got {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (batch * heads, 1, seq) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 "
                             f"[{batch * heads}, 1, {seq}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("dO", do), ("out", out), ("lse", lse),
                    ("delta", delta)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError("the CUDA kernel takes a contiguous, 16-byte "
                         "aligned dO")


def flash_attention_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
        scale: Optional[float] = None, delta: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash attention, the JAX ``_flash_bwd_bhsd`` in the
    [B, S, H, D] layout: q/out/dO [B, S, H, D], k/v [B, S, Hkv, D], lse and
    (optional, precomputed by ring attention) delta [B*H, 1, S] f32.

    CPU tensors run ``flash_attention_backward_reference``; CUDA tensors
    launch the two kernels of ``csrc/flash_bwd.cu`` or raise."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, out, lse, do, causal=causal, scale=scale, delta=delta)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward runs on cuda or cpu, "
                         f"not {q.device}")
    _check_inputs(q, k, v)
    if delta is None:
        delta = flash_bwd_delta(do, out)
    _check_backward_inputs(q, out, lse, do, delta)
    batch, seq, heads, d = q.shape
    code, variant = _DTYPES[q.dtype]
    if scale is None:
        scale = d ** -0.5
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _bwd_library().thp_flash_bwd(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), batch, seq, heads, k.shape[2], d, int(causal),
        float(scale), stream)
    cuda_build.check(status, "flash_bwd")
    _count(f"bwd_{variant}", heads, k.shape[2])
    return dq, dk, dv
