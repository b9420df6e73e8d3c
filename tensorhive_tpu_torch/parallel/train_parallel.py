"""The collectives of sharded training, as ``torch.autograd.Function``s —
what GSPMD inserts into JAX's sharded train step, written out by hand for
one process per rank of a ``TrainMesh``.

Megatron's pair carries tensor parallelism through the backward:

* ``copy_to_tp``: the identity forward, a sum over the tp group backward.
  It stands before every column-parallel product (``wq``, ``wk``, ``wv``,
  ``w_in``, ``w_gate``, the LM head): each tp rank's product yields only
  its heads' share of the input's gradient.
* ``reduce_from_tp``: a sum over the tp group forward, the identity
  backward: the row-parallel partial sums of ``attn @ wo`` and ``gated @
  w_out`` and the vocab-parallel embedding's masked gather.

ZeRO-3 (the fsdp axis) adds ``fsdp_gather``: the forward assembles a whole
leaf from the fsdp group's blocks of its ``embed`` axis; the backward sums
the whole leaf's gradient over the data group (every rank at this tp
coordinate, dp x fsdp of them) and keeps this rank's block, so one
``all_reduce`` does ZeRO's reduce-scatter and the data-parallel sum at
once. The loss is the global mean: each rank's sum over its own rows is
summed over the data group (``data_sum``: forward sum, identity backward)
and divided by the global count, so autograd's own chain rule puts the
``1 / count`` on every rank's gradient and the gathers' backward sums
them.

Sequence parallelism (sp) adds ``ring_shift``, one hop of the ring that
``parallel/ring.py`` runs K/V blocks and their gradients around, and
pipeline parallelism (pp) the stage hand-off ``handoff`` (an
``autograd.Function``: the forward passes each sending stage's activations
to the next stage, the backward passes their gradient back — what JAX's
``ppermute`` is under autodiff) and ``replicate`` (the last stage's
output summed over the stages: every stage then holds it).

Every sum is an f32 ``all_reduce`` and every move a ``broadcast``: gloo
runs only these two on CUDA tensors, so a gather is the sum of zero-filled
buffers (adding zeros is exact), a reduce-scatter a sum then a ``narrow``,
and a point-to-point move one ``broadcast`` from its source over the group
(of the bytes, so any dtype moves bit for bit); one code path serves gloo
and NCCL. Each group is its own ``new_group``, never the default group.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.autograd import Function

from .mesh import TrainMesh, is_staged, map_named, train_spec


def _sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """The f32 sum of ``tensor`` over ``group`` in the input's dtype; the
    identity without a group (a group of one rank)."""
    if group is None:
        return tensor
    total = tensor.to(torch.float32, copy=True)
    dist.all_reduce(total, group=group)
    return total.to(tensor.dtype)


def _assemble(local: torch.Tensor, dim: int, index: int, count: int,
              group) -> torch.Tensor:
    """The whole of a tensor cut in ``count`` contiguous blocks along
    ``dim`` from block ``index``: each rank writes its block into a
    zero-filled f32 buffer and one sum over ``group`` fills it."""
    if group is None:
        return local
    block = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = block * count
    whole = torch.zeros(shape, dtype=torch.float32, device=local.device)
    whole.narrow(dim, index * block, block).copy_(local)
    dist.all_reduce(whole, group=group)
    return whole.to(local.dtype)


def _broadcast_from(buffer: torch.Tensor, index: int, group) -> None:
    """Broadcast contiguous ``buffer`` in place from rank ``index`` of
    ``group`` (its group rank), as bytes."""
    dist.broadcast(buffer.reshape(-1).view(torch.uint8),
                   src=dist.get_global_rank(group, index), group=group)


def ring_shift(tensor: torch.Tensor, group, size: int) -> torch.Tensor:
    """One hop of the ring over ``group`` (``size`` ranks, in group-rank
    order): rank ``i`` passes ``tensor`` to rank ``(i + 1) % size`` and
    gets rank ``(i - 1) % size``'s. One ``broadcast`` per source, every
    rank in the same order; a rank holds its own block and the one in
    flight, never the whole ring's. The identity at size 1. No autograd:
    the ring's own ``autograd.Function`` calls it both ways."""
    if group is None or size == 1:
        return tensor
    me = dist.get_rank(group)
    source = (me - 1) % size
    data = tensor.contiguous()
    received = None
    for index in range(size):
        buffer = data if index == me else torch.empty_like(data)
        _broadcast_from(buffer, index, group)
        if index == source:
            received = buffer
    return received


class _Handoff(Function):
    """One step of the pipeline's hand-off over the pp group: each stage in
    ``senders`` passes its ``send`` ([mb, L, D]) to the next stage, which
    gets it as ``recv`` (an empty tensor on every other stage). ``chain``
    (a 0-d f32 tensor, passed on unchanged) threads every hand-off of a
    pipeline run into one line on every rank, so each rank's backward runs
    the hand-offs in the same order, the last first, whether or not it sent
    or received at that step: the backward moves the receivers' gradient
    back to the senders, one ``broadcast`` per sender."""

    @staticmethod
    def forward(ctx, send, chain, senders, shape, dtype, mesh):
        ctx.senders, ctx.mesh = senders, mesh
        stage, recv = mesh.pp_rank, None
        for sender in senders:
            if stage == sender:
                buffer = send.contiguous()
            else:
                buffer = torch.empty(shape, dtype=dtype, device=mesh.device)
            _broadcast_from(buffer, sender, mesh.pp_group)
            if stage == sender + 1:
                recv = buffer
        ctx.shape, ctx.dtype = shape, dtype
        if recv is None:
            recv = torch.empty(0, dtype=dtype, device=mesh.device)
        return recv, chain.clone()

    @staticmethod
    def backward(ctx, grad_recv, grad_chain):
        mesh, stage, grad_send = ctx.mesh, ctx.mesh.pp_rank, None
        for sender in ctx.senders:
            if stage == sender + 1:
                buffer = grad_recv.contiguous()
            else:
                buffer = torch.empty(ctx.shape, dtype=ctx.dtype,
                                     device=mesh.device)
            _broadcast_from(buffer, sender + 1, mesh.pp_group)
            if stage == sender:
                grad_send = buffer
        return grad_send, grad_chain, None, None, None, None


def handoff(send: Optional[torch.Tensor], chain: torch.Tensor,
            senders: List[int], shape, dtype: torch.dtype,
            mesh: TrainMesh):
    """``(recv, chain)`` of one pipeline step (``_Handoff``): ``send`` is
    this stage's output when it is among ``senders``, else None."""
    return _Handoff.apply(send, chain, tuple(senders), tuple(shape), dtype,
                          mesh)


class _Replicate(Function):
    """The sum over the pp group of ``partial`` (the last stage's output,
    zeros elsewhere): every stage gets the finished activations. Each
    stage computes the same loss from them, so the backward is the
    identity (no sum); ``chain`` gets a zero gradient, which carries every
    rank's backward into the hand-offs."""

    @staticmethod
    def forward(ctx, partial, chain, group):
        return _sum(partial, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, torch.zeros((), dtype=torch.float32,
                                 device=grad.device), None


def replicate(partial: torch.Tensor, chain: torch.Tensor,
              mesh: TrainMesh) -> torch.Tensor:
    return _Replicate.apply(partial, chain, mesh.pp_group)


class _CopyToTP(Function):
    """The identity forward, the sum over ``group`` backward (Megatron's
    ``copy_to_tp``, over whichever group is given)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _SumOver(Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _FsdpGather(Function):
    @staticmethod
    def forward(ctx, shard, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        if dim is None or mesh.fsdp_group is None:
            return shard.view_as(shard)
        return _assemble(shard, dim, mesh.coords["fsdp"], mesh.fsdp,
                         mesh.fsdp_group)

    @staticmethod
    def backward(ctx, grad):
        mesh, dim = ctx.mesh, ctx.dim
        total = _sum(grad, mesh.data_group)
        if dim is not None and mesh.fsdp > 1:
            block = total.shape[dim] // mesh.fsdp
            total = total.narrow(dim, mesh.coords["fsdp"] * block, block)
        return total.contiguous(), None, None


class _AssembleTP(Function):
    """The whole of a tensor cut over tp along its last axis; the
    backward keeps this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, local, mesh):
        ctx.mesh, ctx.block = mesh, local.shape[-1]
        return _assemble(local, local.dim() - 1, mesh.tp_rank, mesh.tp,
                         mesh.tp_group)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.mesh.tp_rank * ctx.block
        return grad.narrow(-1, start, ctx.block).contiguous(), None


class _VocabParallelCE(Function):
    """Per-token ``logsumexp - target logit`` over logits cut over tp
    along the vocab ([N, V / tp] f32 on each rank), without assembling
    them: the row max is an ``all_reduce(MAX)`` (no gradient), the sum of
    exps and the target logit (read only by the rank whose block holds
    the target) f32 sums. The backward is ``(softmax - onehot) * g`` on
    the rank's own columns. Each direction holds two [N, V / tp] buffers
    at most (the logits and the softmax, the softmax and its gradient):
    at a rank's 32,768 tokens of a 32,000 vocab one is 4.2 GB."""

    @staticmethod
    def forward(ctx, logits, targets, mesh):
        block = logits.shape[-1]
        local = targets.long() - mesh.tp_rank * block
        inside = (local >= 0) & (local < block)
        local = torch.where(inside, local, 0)
        row_max = logits.max(dim=-1).values
        if mesh.tp_group is not None:
            dist.all_reduce(row_max, op=dist.ReduceOp.MAX,
                            group=mesh.tp_group)
        exp = (logits - row_max[:, None]).exp_()
        sum_exp = _sum(exp.sum(dim=-1), mesh.tp_group)
        target = torch.gather(logits, -1, local[:, None])[:, 0]
        target = _sum(torch.where(inside, target - row_max, 0.0),
                      mesh.tp_group)
        exp.div_(sum_exp[:, None])                     # now the softmax
        ctx.save_for_backward(exp, local, inside)
        return torch.log(sum_exp) - target

    @staticmethod
    def backward(ctx, grad):
        softmax, local, inside = ctx.saved_tensors
        dlogits = softmax.clone()
        rows = torch.arange(dlogits.shape[0], device=dlogits.device)
        dlogits[rows, local] -= inside.to(dlogits.dtype)
        return dlogits.mul_(grad[:, None]), None, None


def embed_dim(name: str, ndim: int) -> Optional[int]:
    """The axis of a leaf that fsdp cuts (its ``embed`` axis), or None."""
    spec = train_spec(name, ndim)
    return spec.index("fsdp") if "fsdp" in spec else None


class TrainParallel:
    """What the model's functions need of a training mesh: the hooks the
    block functions take (``gather``, ``copy``, ``reduce``), the
    vocab-parallel embedding, LM head and cross entropy, and the data
    group's sum of the loss."""

    def __init__(self, mesh: TrainMesh) -> None:
        self.mesh = mesh
        #: whether a gather is more than the identity either way
        self._gathers = mesh.fsdp > 1 or mesh.data_group is not None

    def gather(self, shard: torch.Tensor, name: str) -> torch.Tensor:
        """The whole of leaf ``name`` (its tp block) from this rank's
        block, for use inside the function that reads it: under
        checkpointing the backward gathers it again instead of keeping it
        alive."""
        if not self._gathers:
            return shard
        return _FsdpGather.apply(shard, embed_dim(name, shard.dim()),
                                 self.mesh)

    def adapter_blocks(self, a: torch.Tensor, b: torch.Tensor, name: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """LoRA's adapters of leaf ``name``, ``a`` [in, rank] and ``b``
        [rank, out], whole on every rank: this rank's rows of ``a`` and
        columns of ``b``, whose product is its block of ``a @ b``. Their
        gradients come from the block's, which the fsdp gather's backward
        has already summed over the data group (dp x fsdp x sp); the other
        blocks' parts are on the ranks that differ in the axes the leaf is
        cut over, so each adapter's gradient is summed over those groups
        (fsdp and tp for ``wq``), and over no other: dp and sp ranks hold
        the same block and the same sum."""
        spec = train_spec(name, 2)
        groups = {"fsdp": self.mesh.fsdp_group, "tp": self.mesh.tp_group}
        for axis in spec:
            if groups.get(axis) is not None:
                a = _CopyToTP.apply(a, groups[axis])
                b = _CopyToTP.apply(b, groups[axis])

        def own(tensor: torch.Tensor, dim: int, axis: Optional[str]):
            if axis is None:
                return tensor
            block = tensor.shape[dim] // self.mesh.axis_sizes[axis]
            return tensor.narrow(dim, self.mesh.coords[axis] * block, block)

        return own(a, 0, spec[0]), own(b, 1, spec[1])

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh.tp_group is None:
            return x
        return _CopyToTP.apply(x, self.mesh.tp_group)

    def reduce(self, partial: torch.Tensor) -> torch.Tensor:
        if self.mesh.tp_group is None:
            return partial
        return _SumOver.apply(partial, self.mesh.tp_group)

    def stage_shared(self, x: torch.Tensor) -> torch.Tensor:
        """The identity forward, the sum over the pp group backward: the
        embedded activations, which only stage 0 feeds into the pipeline,
        so every stage ends with stage 0's gradient of the (pp-replicated)
        embedding."""
        if self.mesh.pp_group is None:
            return x
        return _CopyToTP.apply(x, self.mesh.pp_group)

    def seq_block(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's contiguous block of ``x`` along its sequence axis
        ``dim`` (the whole of it at sp 1)."""
        if self.mesh.sp == 1:
            return x
        length = x.shape[dim]
        if length % self.mesh.sp:
            raise ValueError(f"sp={self.mesh.sp} does not divide the "
                             f"sequence length ({length})")
        block = length // self.mesh.sp
        return x.narrow(dim, self.mesh.sp_rank * block, block)

    def data_sum(self, value: torch.Tensor) -> torch.Tensor:
        if self.mesh.data_group is None:
            return value
        return _SumOver.apply(value, self.mesh.data_group)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
        """The vocab-parallel lookup: rows outside this rank's block of
        ``tok_embed`` read as zeros and the tp group's sum fills them in,
        so the backward scatters only into the rank's own rows (JAX's
        one-hot product gives the same value in f32)."""
        table = self.gather(table, "tok_embed").to(dtype)
        if self.mesh.tp_group is None:
            return table[tokens.long()]
        block = table.shape[0]
        local = tokens.long() - self.mesh.tp_rank * block
        inside = (local >= 0) & (local < block)
        rows = table[torch.where(inside, local, 0)]
        return self.reduce(torch.where(inside[..., None], rows, 0))

    def cross_entropy(self, logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
        """Per-token CE [N] from this rank's vocab columns [N, V / tp]."""
        return _VocabParallelCE.apply(logits, targets, self.mesh)

    def logits(self, local: torch.Tensor) -> torch.Tensor:
        """Whole logits from this rank's vocab columns."""
        if self.mesh.tp_group is None:
            return local
        return _AssembleTP.apply(local, self.mesh)


def sharded_global_norm(leaves: List[torch.Tensor], paths: List[str],
                        mesh: TrainMesh) -> torch.Tensor:
    """optax's ``global_norm`` of a sharded gradient tree: each rank adds
    the squares of the blocks it owns (``TrainMesh.owns``: a norm scale,
    replicated over tp, counts on tp rank 0 only; every leaf on dp and sp
    rank 0 only; the embedding, final norm and head on pp rank 0 only, a
    layer's leaf on its stage) and one f32 sum over the world adds the
    owners' parts, so every element counts once. ``paths`` are the
    leaves' tree paths (``"blocks/0/wq"``; a bare name is a leaf outside
    the layers). The same 0-d f32 tensor on every rank."""
    total = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for leaf, path in zip(leaves, paths):
        name = path.rsplit("/", 1)[-1]
        if mesh.owns(train_spec(name, leaf.dim()), is_staged(path)):
            total += torch.sum(leaf.to(torch.float32) ** 2)
    if mesh.world > 1:
        dist.all_reduce(total)
    return torch.sqrt(total)


def assemble_train_leaf(block: torch.Tensor, name: str,
                        mesh: TrainMesh) -> torch.Tensor:
    """The whole of a training leaf from this rank's block (checks and
    tests; no gradient): assembled over fsdp, then over tp."""
    spec = train_spec(name, block.dim())
    whole = block
    for axis, group in (("fsdp", mesh.fsdp_group), ("tp", mesh.tp_group)):
        if axis in spec:
            whole = _assemble(whole, spec.index(axis), mesh.coords[axis],
                              mesh.axis_sizes[axis], group)
    return whole


def assemble_train_tree(tree, mesh: TrainMesh):
    """``assemble_train_leaf`` over a sharded tree, and under pp every
    stage's layers in order (each stage broadcasts its own): every rank
    gets the whole tree; for checks at small sizes."""
    with torch.no_grad():
        whole = map_named(
            lambda leaf, name: assemble_train_leaf(leaf, name, mesh), tree)
        if mesh.pp_group is None or "blocks" not in whole:
            return whole
        own = whole["blocks"]
        layers = []
        for stage in range(mesh.pp):
            for local in own:
                def move(leaf, name, stage=stage):
                    buffer = (leaf.contiguous() if stage == mesh.pp_rank
                              else torch.empty_like(leaf))
                    _broadcast_from(buffer, stage, mesh.pp_group)
                    return buffer
                layers.append(map_named(move, local))
        return {**whole, "blocks": layers}
