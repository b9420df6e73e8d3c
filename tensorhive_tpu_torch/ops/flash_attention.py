"""Flash attention forward — the PyTorch + CUDA counterpart of
``tensorhive_tpu/ops/flash_attention.py`` (forward half).

``flash_attention`` launches the hand-written kernel ``csrc/flash_fwd.cu``
for CUDA tensors and runs its plain PyTorch version,
``reference_attention``, for CPU tensors — at any sequence length: the
JAX dispatch falls back to the reference when S does not divide the block
(a 3000-token prompt pads to the 4095 bucket), the kernel here masks the
ragged tile itself, so a CUDA tensor never reaches the plain version.

``launches`` counts kernel launches per input type; the kernel-vs-plain
checks call ``reference_attention`` directly and do not count. The
backward kernels (training) are not ported yet; ``return_lse`` and
``scale`` are kept for them and for ring attention.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple, Union

import torch

from . import cuda_build

NEG_INF = -1e30

#: kernel launches per input type (the main-path counters)
launches: Dict[str, int] = {"bf16": 0, "f32": 0}

_DTYPES = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16")}
_HEAD_DIMS = (16, 32, 64, 128)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        return_lse: bool = False
                        ) -> Union[torch.Tensor,
                                   Tuple[torch.Tensor, torch.Tensor]]:
    """Plain softmax attention with f32 accumulation — the JAX oracle
    term for term. q [B, Sq, H, D], k/v [B, Sk, Hkv, D]; GQA is expanded
    here (``repeat_interleave``: head h uses KV head h // group). The causal
    mask is bottom-right aligned (``tril(.., Sk - Sq)``). With
    ``return_lse`` also returns the row log-sum-exp as [B*H, 1, Sq] f32."""
    if k.shape[2] != q.shape[2]:
        group = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        seq_q, seq_k = scores.shape[2], scores.shape[3]
        mask = torch.ones(seq_q, seq_k, dtype=torch.bool,
                          device=q.device).tril(seq_k - seq_q)
        scores.masked_fill_(~mask, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1) if return_lse else None
    probs = torch.softmax(scores, dim=-1)
    del scores
    out = torch.einsum("bhqk,bkhd->bqhd", probs,
                       v.to(torch.float32)).to(q.dtype)
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
    return library


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
    if d not in _HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes d_head in {_HEAD_DIMS}, "
                         f"got {d}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous q/k/v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the CUDA kernel loads 16-byte vectors: q/k/v must "
                         "start 16-byte aligned")
    if batch * heads > 65535:
        raise ValueError("batch * heads must be <= 65535")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    return_lse: bool = False
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Fused attention forward. q [B, S, H, D]; k, v [B, S, Hkv, D] with
    H % Hkv == 0 (GQA native: no expanded K/V copy). Returns O [B, S, H, D]
    in q's dtype and, with ``return_lse``, LSE [B*H, 1, S] f32.

    CPU tensors run ``reference_attention``; CUDA tensors launch the kernel
    or raise — there is no fallback."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal, scale=scale,
                                   return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check_inputs(q, k, v)
    batch, seq, heads, d = q.shape
    code, variant = _DTYPES[q.dtype]
    out = torch.empty_like(q)
    lse = torch.empty((batch * heads, 1, seq), dtype=torch.float32,
                      device=q.device)
    if scale is None:
        scale = d ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _library().thp_flash_fwd(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), batch, seq, heads, k.shape[2], d, int(causal),
        float(scale), stream)
    cuda_build.check(status, "flash_fwd")
    launches[variant] += 1
    return (out, lse) if return_lse else out
