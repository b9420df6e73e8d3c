"""Ring attention: exact attention over sequence shards — the PyTorch
counterpart of ``tensorhive_tpu/parallel/ring.py``'s flash-ring
(``_flash_ring_local`` and its custom VJP).

The sequence is cut over the ``sp`` axis of a training mesh: rank ``i`` of
the ring holds the ``i``-th block of q, k and v ([B, S/sp, H, D]; K/V at
their own head count, GQA native). At step ``s`` it holds the K/V block of
rank ``(i - s) % sp`` and passes it on (``train_parallel.ring_shift``: one
hop, one block in flight). Each step runs the flash kernels on the pair
(K1/K2 forward, K4–K7 backward, ``ops/flash_attention.py``), in the mode
``_ring_mode`` gives (JAX ``ring.py:202-208``):

* the diagonal block (``k_index == i``): causal;
* a past block (``k_index < i``), and every block of non-causal attention:
  full;
* a future block: nothing is launched (rank ``i`` of a causal ring runs
  ``i + 1`` forward and ``i + 1`` backward launches a layer).

Forward: each step's normalised output and LSE merge into f32 ``out_run``
and ``lse_run`` by ``logaddexp`` (``lse_run`` starts at -1e30; every row
has its diagonal block, so none ends empty). Backward: ``delta = rowsum(dO
* O)`` once from the merged O, then at each live step the backward kernels
with the merged LSE and delta; dQ accumulates in f32 on the rank, dK/dV in
f32 accumulators at KV width that rotate with the K/V blocks and take one
more hop after the last step, which brings each home (JAX ``ring.py:261``:
only the accumulators move then).

There is one body: no dense blockwise fallback (JAX's ``_block_attend``
and ``_ring_attention_local``) and no head expansion (``_ring_body_plan``).
The kernels take every S, and on CPU tensors their wrappers run the plain
versions. ``flash_bh_block`` does not apply inside the ring: as JAX's, it
runs the per-head forward.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.autograd import Function

from ..ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_backward,
    flash_bwd_delta,
)
from .train_parallel import ring_shift

#: ``_ring_mode``'s values
DIAGONAL, PAST, FUTURE = 0, 1, 2


def _ring_mode(my_index: int, step: int, size: int, causal: bool) -> int:
    """The mode of ring step ``step`` for the q block of rank
    ``my_index``."""
    if not causal:
        return PAST
    k_index = (my_index - step) % size
    if k_index == my_index:
        return DIAGONAL
    return PAST if k_index < my_index else FUTURE


def _heads_last(lse: torch.Tensor, batch: int, heads: int) -> torch.Tensor:
    """[B*H, 1, S] -> [B, S, H, 1], to weight a [B, S, H, D] output."""
    seq = lse.shape[-1]
    return lse.reshape(batch, heads, seq).permute(0, 2, 1)[..., None]


class _RingAttention(Function):
    """The flash-ring as one autograd node over local shards."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, causal: bool):
        group, size, me = mesh.sp_group, mesh.sp, mesh.sp_rank
        batch, seq, heads, _ = q.shape
        out_run = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse_run = torch.full((batch * heads, 1, seq), NEG_INF,
                             dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        for step in range(size):
            mode = _ring_mode(me, step, size, causal)
            if mode != FUTURE:
                out_i, lse_i = flash_attention(
                    q, k_cur, v_cur, causal=mode == DIAGONAL,
                    return_lse=True)
                new_lse = torch.logaddexp(lse_run, lse_i)
                w_run = torch.exp(_heads_last(lse_run - new_lse, batch, heads))
                w_i = torch.exp(_heads_last(lse_i - new_lse, batch, heads))
                out_run = out_run * w_run + out_i.to(torch.float32) * w_i
                lse_run = new_lse
            if step < size - 1:
                k_cur = ring_shift(k_cur, group, size)
                v_cur = ring_shift(v_cur, group, size)
        out = out_run.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse_run)
        ctx.mesh, ctx.causal = mesh, causal
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, causal = ctx.mesh, ctx.causal
        group, size, me = mesh.sp_group, mesh.sp, mesh.sp_rank
        grad_out = grad_out.contiguous()
        delta = flash_bwd_delta(grad_out, out)
        dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        for step in range(size):
            mode = _ring_mode(me, step, size, causal)
            if mode != FUTURE:
                dq_i, dk_i, dv_i = flash_attention_backward(
                    q, k_cur, v_cur, out, lse, grad_out,
                    causal=mode == DIAGONAL, delta=delta)
                dq_acc += dq_i.to(torch.float32)
                dk_cur += dk_i.to(torch.float32)
                dv_cur += dv_i.to(torch.float32)
            if step < size - 1:
                k_cur = ring_shift(k_cur, group, size)
                v_cur = ring_shift(v_cur, group, size)
            # the accumulators ride with their blocks, and once more after
            # the last step: home to the block's owner
            dk_cur = ring_shift(dk_cur, group, size)
            dv_cur = ring_shift(dv_cur, group, size)
        return (dq_acc.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype),
                None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Any = None, causal: bool = True) -> torch.Tensor:
    """Exact attention with the sequence cut over the mesh's sp ranks, the
    counterpart of JAX's ``ring_attention`` and ``ring_attention_local``
    both. q [B, S/sp, H, D], k/v [B, S/sp, Hkv, D]: this rank's blocks
    (block ``mesh.sp_rank`` of the sequence). Without a mesh or at sp 1 it
    is ``flash_attention`` on the whole sequence. Differentiable in q, k
    and v; dK/dV come back at KV width."""
    if mesh is None or mesh.sp == 1:
        return flash_attention(q, k, v, causal=causal)
    return _RingAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), mesh, causal)


__all__ = ["ring_attention"]
