"""Pipeline parallelism: the transformer's layers in stages over the ``pp``
axis of a training mesh — the PyTorch counterpart of
``tensorhive_tpu/parallel/pipeline.py`` (GPipe, JAX's schedule).

Each pp rank holds only its stage's ``n_layers / pp`` layers
(``TrainMesh.stage_layers``; JAX stores every layer on every pp device and
re-shards a stacked copy in the step). The embedding, final norm and LM
head stay whole on every stage, as in JAX.

Schedule: a rank's rows split into M microbatches; for ``M + pp - 1``
steps stage ``s`` applies its layers to microbatch ``t - s`` when it has
one (stage 0 takes it from the embedded input, every other stage from the
hand-off of the step before) and hands the result to stage ``s + 1``
(``train_parallel.handoff``); the last stage keeps what it finishes, and a
sum over the pp group (``train_parallel.replicate``) gives every stage the
whole output. A stage with no microbatch at a step skips its compute, and
with it only collectives of its own stage's groups, which every rank of
those groups skips alike; the hand-offs run from the stages that send at
that step, known to every rank. The bubble is JAX's ``(pp - 1) / (M + pp -
1)``.

Microbatches under a mesh: JAX's microbatch ``i`` is rows ``[i mb, (i+1)
mb)`` of the global batch; here each rank splits its own rows. The loss is
computed after the pipeline on the whole of each rank's rows, so it is the
same either way.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch

from .train_parallel import handoff, replicate

#: apply a stage's layers: (x [mb, L, D], positions [mb, L]) -> x
StageFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def pp_enabled(mesh: Any) -> bool:
    return mesh is not None and getattr(mesh, "pp", 1) > 1


def pipeline_microbatches(batch: int, mesh: Any, requested: int = 0) -> int:
    """Microbatch count: the requested value, else one per stage; it must
    divide ``batch`` (a rank's rows)."""
    count = requested or mesh.pp
    if batch % count:
        raise ValueError(
            f"batch {batch} not divisible by {count} pipeline microbatches")
    return count


def pipeline_apply(apply_stage: StageFn, x: torch.Tensor,
                   positions: torch.Tensor, mesh: Any,
                   num_microbatches: int = 0,
                   anchors: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """Run this rank's stage (``apply_stage``: its layers in order, each
    checkpointed as the caller's remat asks) as one stage of a ``pp``-stage
    pipeline over ``x`` [rows, L, D] (this rank's rows; under sp its
    sequence block) and its ``positions`` [rows, L]. Returns the last
    stage's output on every stage, [rows, L, D]. Only stage 0 reads ``x``;
    pass it through ``TrainParallel.stage_shared`` so every stage ends
    with its gradient. ``anchors``: the stage's own weights, which the
    hand-offs' chain starts from when ``x`` needs no gradient (a frozen
    embedding, as under LoRA)."""
    pp, stage = mesh.pp, mesh.pp_rank
    rows = x.shape[0]
    count = pipeline_microbatches(rows, mesh, num_microbatches)
    size = rows // count
    x_mb = x.split(size)
    pos_mb = positions.split(size)
    shape = (size,) + tuple(x.shape[1:])
    # one 0-d tensor threads every hand-off into one line (see handoff);
    # it starts from x so that every stage's backward reaches the input.
    # ``torch.autograd.grad`` runs only the nodes on a path to the leaves
    # it is asked for: with x frozen, a stage's hand-offs would lead to
    # none of its own, and it would skip the broadcasts another stage
    # waits in, so the chain then starts from the stage's own weights
    chain = x.sum(dtype=torch.float32) * 0.0
    if not chain.requires_grad:
        for leaf in anchors:
            if leaf.requires_grad:
                chain = chain + leaf.sum(dtype=torch.float32) * 0.0
    outputs: List[Optional[torch.Tensor]] = [None] * count
    received: Optional[torch.Tensor] = None
    for t in range(count + pp - 1):
        index = t - stage
        out = None
        if 0 <= index < count:
            current = x_mb[index] if stage == 0 else received
            out = apply_stage(current, pos_mb[index])
            if stage == pp - 1:
                outputs[index] = out
        senders = [s for s in range(pp - 1) if 0 <= t - s < count]
        if senders:
            received, chain = handoff(out if stage in senders else None,
                                      chain, senders, shape, x.dtype, mesh)
    if stage == pp - 1:
        finished = torch.cat(outputs)
    else:
        finished = torch.zeros_like(x)
    return replicate(finished, chain, mesh)


__all__ = ["pipeline_apply", "pipeline_microbatches", "pp_enabled"]
