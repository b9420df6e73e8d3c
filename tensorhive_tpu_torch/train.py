"""Training: optimizer, train step, loop, checkpoints, synthetic data — the
PyTorch counterpart of ``tensorhive_tpu/train.py``, on one device or on a
``pp x dp x fsdp x tp x sp`` training mesh (``parallel.mesh.train_mesh``).

* ``make_optimizer`` is optax's ``chain(clip_by_global_norm(max_norm),
  adamw(warmup_cosine_decay_schedule(0, lr, warmup, total), weight_decay))``
  written out in torch with f32 state: the clip scales by
  ``max_norm / g_norm`` only when ``g_norm >= max_norm`` (no epsilon, unlike
  ``clip_grad_norm_``); Adam uses b1 0.9, b2 0.999, eps 1e-8 outside the
  square root and bias correction; the decay ``wd * p`` is added to every
  leaf; the learning rate is read at the step count before the increment,
  so the first step has lr 0 and leaves the params as they were.
* ``make_train_step`` returns ``step(params, opt_state, tokens) ->
  (params, opt_state, metrics)`` with f32 gradient accumulation over
  ``grad_accum_steps`` microbatches; ``metrics["grad_norm"]`` is the norm
  before clipping. Params and optimizer state are f32 and are updated in
  place (the JAX step donates its buffers instead), so a step holds no
  second copy of either.
* Checkpoints are ``torch.save`` files, one per step, keeping the newest
  ``max_to_keep``; on a mesh, a directory per step with one file per
  owning rank (a pp stage's layers under their global indices), restored
  onto any other mesh shape.

Params and gradients are the plain param dict of ``models/transformer``.
On a mesh each rank holds only its block of every f32 param and of Adam's
``mu`` and ``nu`` (JAX's ``tree_shardings`` and ``_opt_state_shardings``)
and, under pp, only its stage's layers; it steps on its rows of the global
batch (``B / (dp x fsdp)``, block ``mesh.data_rank``; every sp, tp and pp
rank of a data shard holds the same rows, and under sp takes its block of
the sequence) and computes the same loss, gradient norm and update as one
device on the global batch. Entry points that make tensors take ``device=None``, which
means CUDA and raises without a card.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import re
import shutil
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from .device import DeviceLike, resolve_device
from .models.transformer import Params, TransformerConfig, TransformerLM
from .parallel.mesh import (
    TrainMesh,
    block_starts,
    check_train_mesh,
    is_staged,
    named_leaves,
    shard_train_leaf,
    train_spec,
    whole_shape,
)
from .parallel.train_parallel import sharded_global_norm

log = logging.getLogger(__name__)

OptState = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    batch_size: int = 8          # tokens-batch per optimizer step
    seq_len: int = 512
    #: microbatches per optimizer step (1 = none): the [batch_size, ...]
    #: input (LM [B, L+1], packed MLM [B, 3, L]) is split along its batch
    #: axis into grad_accum_steps microbatches run one after the
    #: other with f32 gradient accumulation
    grad_accum_steps: int = 1


# -- param trees ---------------------------------------------------------------

def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Tensors of a nested dict/list tree, in a fixed order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def leaf_names(tree: Any) -> List[str]:
    """The last key of each leaf's path, in ``tree_leaves`` order (the
    name a mesh's sharding rules read: ``"wq"``, ``"scale"``, ...)."""
    return [name for name, _ in named_leaves(tree)]


def leaf_paths(tree: Any, prefix: str = "") -> List[str]:
    """Each leaf's path (``"blocks/0/wq"``), in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in leaf_paths(tree[key], f"{prefix}{key}/")]
    if isinstance(tree, (list, tuple)):
        return [leaf for index, item in enumerate(tree)
                for leaf in leaf_paths(item, f"{prefix}{index}/")]
    return [prefix.rstrip("/")]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``) in ``tree_leaves`` order, keeping the structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, item, *(r[i] for r in rest))
                for i, item in enumerate(tree)]
    return fn(tree, *rest)


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), as
    a 0-d f32 tensor on the leaves' device."""
    return torch.sqrt(sum(torch.sum(leaf.to(torch.float32) ** 2)
                          for leaf in leaves))


# -- optimizer -----------------------------------------------------------------

def warmup_cosine_decay(count: int, peak: float, warmup_steps: int,
                        decay_steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps) at step ``count``: linear from 0 to ``peak`` over
    ``warmup_steps``, then a cosine to 0 over the remaining
    ``decay_steps - warmup_steps``."""
    if count < warmup_steps:
        return peak * count / warmup_steps
    span = decay_steps - warmup_steps
    done = min(count - warmup_steps, span)
    return peak * 0.5 * (1.0 + math.cos(math.pi * done / span))


class AdamW:
    """``clip_by_global_norm`` -> ``adamw`` with a warmup-cosine schedule,
    as ``make_optimizer`` in the JAX package builds it with optax. The
    state is ``{"count": int, "mu": tree, "nu": tree}`` with f32 moments
    shaped like the params."""

    b1 = 0.9
    b2 = 0.999
    eps = 1e-8

    def __init__(self, config: TrainConfig) -> None:
        if config.total_steps <= config.warmup_steps:
            raise ValueError(f"total_steps ({config.total_steps}) must exceed "
                             f"warmup_steps ({config.warmup_steps})")
        self.config = config

    def learning_rate(self, count: int) -> float:
        config = self.config
        return warmup_cosine_decay(count, config.learning_rate,
                                   config.warmup_steps, config.total_steps)

    def init(self, params: Params) -> OptState:
        def zeros(p: torch.Tensor) -> torch.Tensor:
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(self, grads: Params, state: OptState, params: Params,
               g_norm: Optional[torch.Tensor] = None) -> OptState:
        """Apply one step to ``params`` in place; returns the new state
        (its moments updated in place). ``g_norm``: the global norm of the
        gradients when they are a mesh rank's blocks (the clip needs the
        norm of the whole tree); computed from ``grads`` when None."""
        grad_leaves = tree_leaves(grads)
        if g_norm is None:
            g_norm = global_norm(grad_leaves)
        max_norm = self.config.max_grad_norm
        clip = torch.where(g_norm < max_norm, torch.ones_like(g_norm),
                           max_norm / g_norm)
        count = state["count"] + 1
        lr = self.learning_rate(state["count"])
        correction1 = 1.0 - self.b1 ** count
        correction2 = 1.0 - self.b2 ** count
        decay = self.config.weight_decay
        for grad, mu, nu, param in zip(grad_leaves, tree_leaves(state["mu"]),
                                       tree_leaves(state["nu"]),
                                       tree_leaves(params)):
            grad = grad.to(torch.float32) * clip
            mu.mul_(self.b1).add_(grad, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(grad, grad, value=1.0 - self.b2)
            update = (mu / correction1) / (torch.sqrt(nu / correction2)
                                           + self.eps)
            update.add_(param, alpha=decay)
            param.add_(update.to(param.dtype), alpha=-lr)
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}


def make_optimizer(config: TrainConfig) -> AdamW:
    return AdamW(config)


# -- state and step ------------------------------------------------------------

def init_train_state(model_config: TransformerConfig,
                     train_config: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None,
                     mesh: Any = None) -> Tuple[Params, OptState]:
    """f32 master params from ``TransformerLM.init`` (draws from
    ``generator``, default seed 0 on the device) and a fresh optimizer
    state. On a ``mesh`` the state lives on ``mesh.device``: every rank
    draws each leaf whole, in ``init``'s fixed order, and keeps its block
    and its pp stage's layers (so the global params are the same whatever
    the mesh, and a rank holds its shard plus one whole leaf at most);
    ``mu`` and ``nu`` mirror the param blocks and ``count`` is replicated
    (JAX's ``_opt_state_shardings``)."""
    shard = layers = None
    if mesh is None:
        device = resolve_device(device)
    else:
        check_train_mesh(model_config, mesh)
        device = _mesh_device(mesh, device)
        layers = mesh.stage_layers(model_config.n_layers)

        def shard(leaf: torch.Tensor, name: str) -> torch.Tensor:
            return shard_train_leaf(leaf, name, mesh)
    params = TransformerLM.init(model_config, generator, device,
                                param_dtype=torch.float32, shard=shard,
                                layers=layers)
    return params, make_optimizer(train_config).init(params)


def _mesh_device(mesh: TrainMesh, device: DeviceLike) -> torch.device:
    """A mesh rank's state lives on the mesh's device; another device
    asked for beside it is refused."""
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} differs from the mesh's "
                         f"{mesh.device}")
    return mesh.device


def abstract_train_state(model_config: TransformerConfig,
                         train_config: TrainConfig, mesh: Any = None
                         ) -> Tuple[Params, OptState]:
    """(params, opt_state) templates on the ``meta`` device, at this
    rank's local shapes on ``mesh`` (whole shapes without one): no memory
    at all. ``restore_checkpoint`` allocates only the restored blocks
    into them, so a resume never holds a throwaway initialised copy beside
    the restored one (JAX's ``abstract_train_state``)."""
    shard = layers = None
    if mesh is not None:
        check_train_mesh(model_config, mesh)
        layers = mesh.stage_layers(model_config.n_layers)

        def shard(leaf: torch.Tensor, name: str) -> torch.Tensor:
            return shard_train_leaf(leaf, name, mesh)
    params = TransformerLM.init(model_config, device="meta",
                                param_dtype=torch.float32, shard=shard,
                                layers=layers)
    return params, make_optimizer(train_config).init(params)


def make_train_step(model_config: TransformerConfig,
                    train_config: TrainConfig, mesh: Any = None,
                    loss_fn: Callable = TransformerLM.loss) -> Callable:
    """``step(params, opt_state, tokens) -> (params, opt_state, metrics)``
    on the device the params live on. ``loss_fn(params, tokens,
    model_config)`` defaults to the causal LM loss; the MLM encoder passes
    ``models.encoder.mlm_loss_packed`` with [B, 3, L] batches, LoRA
    ``models.lora.lora_loss`` with the adapter tree as ``params``.
    ``metrics`` holds 0-d device tensors ``loss`` and ``grad_norm`` (reading
    them syncs).

    On a ``mesh`` the step takes a rank's shard and its ``B / (dp x
    fsdp)`` rows, calls ``loss_fn(params, tokens, model_config, mesh)``
    (which returns the global loss), clips by the global gradient norm
    (``metrics["grad_norm"]``, the same on every rank) and updates the
    rank's blocks. Accumulation splits the rank's rows: the mean of equal
    micro means is the global mean, as in JAX."""
    optimizer = make_optimizer(train_config)
    accum = train_config.grad_accum_steps
    if accum < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {accum}")
    if accum > 1 and train_config.batch_size % accum:
        raise ValueError(
            f"batch_size {train_config.batch_size} not divisible by "
            f"grad_accum_steps {accum}")
    rows = train_config.batch_size
    if mesh is not None:
        check_train_mesh(model_config, mesh, train_config.batch_size, accum,
                         train_config.seq_len)
        rows //= mesh.data_size

    def value_and_grad(params: Params, tokens: torch.Tensor
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = (loss_fn(live, tokens, model_config) if mesh is None
                else loss_fn(live, tokens, model_config, mesh))
        return loss.detach(), list(torch.autograd.grad(loss,
                                                       tree_leaves(live)))

    def loss_and_grads(params: Params, tokens: torch.Tensor
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        if accum <= 1:
            return value_and_grad(params, tokens)
        loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        sums = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in tree_leaves(params)]
        # split the leading (batch) axis only: an MLM batch is [B, 3, L]
        micro = rows // accum
        for micro_batch in tokens.reshape(accum, micro, *tokens.shape[1:]):
            loss, grads = value_and_grad(params, micro_batch)
            loss_sum += loss
            for total, grad in zip(sums, grads):
                total += grad.to(torch.float32)
        scale = 1.0 / accum
        return loss_sum * scale, [total * scale for total in sums]

    def step(params: Params, opt_state: OptState, tokens: torch.Tensor
             ) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
        if mesh is not None and tokens.shape[0] != rows:
            raise ValueError(
                f"a rank of a {mesh.data_size}-way data mesh steps on its "
                f"{rows} rows of the global batch of "
                f"{train_config.batch_size}, got {tokens.shape[0]}")
        loss, grad_leaves = loss_and_grads(params, tokens)
        if mesh is None:
            grad_norm = global_norm(grad_leaves)
        else:
            grad_norm = sharded_global_norm(grad_leaves, leaf_paths(params),
                                            mesh)
        grads = _unflatten(params, grad_leaves)
        opt_state = optimizer.update(grads, opt_state, params, grad_norm)
        return params, opt_state, {"loss": loss, "grad_norm": grad_norm}

    return step


def _unflatten(like: Any, leaves: List[torch.Tensor]) -> Any:
    """``leaves`` (in ``tree_leaves`` order) back into ``like``'s
    structure."""
    remaining = iter(leaves)
    return tree_map(lambda _: next(remaining), like)


def synthetic_batch(generator: torch.Generator, train_config: TrainConfig,
                    vocab_size: int, device: DeviceLike = None
                    ) -> torch.Tensor:
    """Uniform random LM batch [B, L+1] int32 from ``generator`` (which
    must live on ``device``)."""
    device = resolve_device(device)
    return torch.randint(0, vocab_size,
                         (train_config.batch_size, train_config.seq_len + 1),
                         generator=generator, device=device,
                         dtype=torch.int32)


# -- checkpoints ---------------------------------------------------------------

_CHECKPOINT = re.compile(r"^step_(\d+)\.pt$")
_MESH_CHECKPOINT = re.compile(r"^step_(\d+)\.ranks$")
_RANK_FILE = re.compile(
    r"^(?:pp(\d+)_)?fsdp(\d+)_tp(\d+)_of_(?:(\d+)x)?(\d+)x(\d+)\.pt$")


def _rank_file(p: int, f: int, t: int, pp: int, fsdp: int, tp: int) -> str:
    """The file of coordinate (pp p, fsdp f, tp t) of a ``pp x fsdp x tp``
    set (the pp part only where the mesh has stages)."""
    if pp == 1:
        return f"fsdp{f}_tp{t}_of_{fsdp}x{tp}.pt"
    return f"pp{p}_fsdp{f}_tp{t}_of_{pp}x{fsdp}x{tp}.pt"


def _rank_files(directory: Path) -> List[Path]:
    """The files of a complete set in a mesh step's directory (one per
    (pp, fsdp, tp) coordinate of the mesh that wrote it), or none."""
    sets: Dict[Tuple[int, int, int], set] = {}
    for name in os.listdir(directory):
        match = _RANK_FILE.match(name)
        if match:
            p, f, t, pp, fsdp, tp = (int(group or 0)
                                     for group in match.groups())
            sets.setdefault((pp or 1, fsdp, tp), set()).add((p, f, t))
    for (pp, fsdp, tp), found in sorted(sets.items()):
        if len(found) == pp * fsdp * tp:
            return [directory / _rank_file(p, f, t, pp, fsdp, tp)
                    for p, f, t in sorted(found)]
    return []


def _global_path(path: str, first_layer: int) -> str:
    """A leaf's path with its layer index made global (``blocks/1/wq`` of
    a stage whose first layer is 4 -> ``blocks/5/wq``)."""
    if not is_staged(path) or not first_layer:
        return path
    _, index, rest = path.split("/", 2)
    return f"blocks/{int(index) + first_layer}/{rest}"


def _first_layer(tree: Any, mesh: Any) -> int:
    """The global index of a stage's first layer in ``tree`` (0 off a pp
    mesh)."""
    if mesh is None or mesh.pp == 1:
        return 0
    return mesh.pp_rank * len(tree.get("blocks", ()))


def _checkpoints(path: Path) -> Dict[int, Path]:
    """Step -> its ``step_<n>.pt`` file, or its ``step_<n>.ranks``
    directory once every file of the mesh that wrote it is there."""
    if not path.is_dir():
        return {}
    found = {}
    for name in os.listdir(path):
        match = _CHECKPOINT.match(name) or _MESH_CHECKPOINT.match(name)
        if match and (name.endswith(".pt") or _rank_files(path / name)):
            found[int(match.group(1))] = path / name
    return found


def checkpoint_steps(path) -> List[int]:
    """Steps of the complete checkpoints under ``path``, ascending (none
    for a missing directory)."""
    return sorted(_checkpoints(Path(path)))


def _prune(directory: Path, max_to_keep: int) -> None:
    found = _checkpoints(directory)
    for old in sorted(found)[:-max_to_keep]:
        if found[old].is_dir():
            shutil.rmtree(found[old])
        else:
            found[old].unlink()


def save_checkpoint(path: str, step: int, params: Params, opt_state: OptState,
                    max_to_keep: int = 3, mesh: Any = None) -> None:
    """Write ``path/step_<step>.pt`` (atomically: a temporary file, then a
    rename) and delete all but the newest ``max_to_keep`` steps.

    On a ``mesh`` every rank calls this: each rank at dp and sp
    coordinate 0 writes ``step_<step>.ranks/fsdp<f>_tp<t>_of_<F>x<T>.pt``
    (``pp<p>_fsdp<f>_tp<t>_of_<P>x<F>x<T>.pt`` under pp) atomically,
    holding only the blocks of the params, ``mu`` and ``nu`` it owns
    (``TrainMesh.owns``: tp rank 0 for the norm scales, which are
    replicated over tp, pp rank 0 for the embedding, final norm and head,
    fsdp and tp rank 0 for a leaf whole on every rank such as a LoRA
    adapter; each with its start and the leaf's whole shape; a stage's
    layers under their global indices), the mesh shape, its coordinates,
    the step and Adam's count. A file may hold no block: the set is
    complete when every coordinate's file is there. Other dp and sp ranks
    hold copies of those blocks and write nothing. Rank 0 prunes after
    every rank has written."""
    directory = Path(path)
    directory.mkdir(parents=True, exist_ok=True)
    if mesh is None:
        target = directory / f"step_{step:010d}.pt"
        partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        torch.save({"step": step, "params": params, "opt_state": opt_state},
                   partial)
        os.replace(partial, target)
    else:
        _save_blocks(directory, step, params, opt_state, mesh)
        if mesh.world > 1:          # every file is in place before a prune
            done = torch.zeros(1, device=mesh.device)
            dist.all_reduce(done)
        if mesh.rank:
            return
    _prune(directory, max_to_keep)


def _save_blocks(directory: Path, step: int, params: Params,
                 opt_state: OptState, mesh: TrainMesh) -> None:
    position = mesh.position
    if position["dp"] or position["sp"]:
        return                  # its blocks are copies of dp 0's, sp 0's
    blocks, starts, shapes = {}, {}, {}
    first_layer = _first_layer(params, mesh)
    for prefix, tree in (("params", params), ("mu", opt_state["mu"]),
                         ("nu", opt_state["nu"])):
        for path, name, leaf in zip(leaf_paths(tree), leaf_names(tree),
                                    tree_leaves(tree)):
            spec = train_spec(name, leaf.dim())
            if not mesh.owns(spec, is_staged(path)):
                continue
            whole = whole_shape(leaf.shape, spec, mesh)
            key = f"{prefix}/{_global_path(path, first_layer)}"
            blocks[key] = leaf.detach().cpu()
            starts[key] = block_starts(whole, spec, mesh)
            shapes[key] = whole
    coords = mesh.coords
    step_dir = directory / f"step_{step:010d}.ranks"
    step_dir.mkdir(exist_ok=True)
    target = step_dir / _rank_file(mesh.pp_rank, coords["fsdp"],
                                   coords["tp"], mesh.pp, mesh.fsdp, mesh.tp)
    partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    torch.save({"step": step, "count": int(opt_state["count"]),
                "mesh": mesh.axis_sizes,
                "coords": coords, "blocks": blocks, "starts": starts,
                "shapes": shapes}, partial)
    os.replace(partial, target)


def _sources(entry: Path) -> Tuple[List[Tuple[Dict, Dict, Dict]], int]:
    """The saved blocks of one step as (blocks, starts, whole shapes) per
    file, memory-mapped (only the bytes a restore copies are read), and
    Adam's count. A single-device file is one source of whole leaves."""
    def load(file: Path) -> Dict[str, Any]:
        return torch.load(file, map_location="cpu", weights_only=True,
                          mmap=True)

    if entry.is_dir():
        saved = [load(file) for file in _rank_files(entry)]
        return ([(s["blocks"], s["starts"], s["shapes"]) for s in saved],
                int(saved[0]["count"]))
    saved = load(entry)
    blocks = {}
    for prefix, tree in (("params", saved["params"]),
                         ("mu", saved["opt_state"]["mu"]),
                         ("nu", saved["opt_state"]["nu"])):
        for path, leaf in zip(leaf_paths(tree), tree_leaves(tree)):
            blocks[f"{prefix}/{path}"] = leaf
    starts = {key: (0,) * leaf.dim() for key, leaf in blocks.items()}
    shapes = {key: tuple(leaf.shape) for key, leaf in blocks.items()}
    return [(blocks, starts, shapes)], int(saved["opt_state"]["count"])


def _restore_leaf(key: str, name: str, like: torch.Tensor,
                  sources: List[Tuple[Dict, Dict, Dict]], mesh: Any,
                  device: DeviceLike) -> torch.Tensor:
    """This rank's block of one leaf (the template's shape, dtype and
    device; a ``meta`` template's goes to the mesh's device), copied from
    every saved block that overlaps it."""
    spec = (train_spec(name, like.dim()) if mesh is not None
            else (None,) * like.dim())
    if mesh is None:
        whole, start = tuple(like.shape), (0,) * like.dim()
    else:
        whole = whole_shape(like.shape, spec, mesh)
        start = block_starts(whole, spec, mesh)
    target = like.device
    if target.type == "meta":
        target = mesh.device if mesh is not None else resolve_device(device)
    out = torch.empty(like.shape, dtype=like.dtype, device=target)
    filled = 0
    for blocks, starts, shapes in sources:
        if key not in blocks:
            continue
        if tuple(shapes[key]) != whole:
            raise ValueError(f"checkpoint leaf {key} {tuple(shapes[key])} "
                             f"does not match the template {whole}")
        piece, there = blocks[key], starts[key]
        lo = [max(a, b) for a, b in zip(start, there)]
        hi = [min(a + n, b + m) for a, n, b, m in
              zip(start, like.shape, there, piece.shape)]
        if any(low >= high for low, high in zip(lo, hi)):
            continue
        into = out
        for dim, (low, high) in enumerate(zip(lo, hi)):
            piece = piece.narrow(dim, low - there[dim], high - low)
            into = into.narrow(dim, low - start[dim], high - low)
        into.copy_(piece)
        filled += piece.numel()
    if filled != out.numel():
        raise ValueError(f"checkpoint holds {filled} of the {out.numel()} "
                         f"elements of {key} this rank needs")
    return out


def restore_checkpoint(path: str, params_like: Params,
                       opt_state_like: OptState, mesh: Any = None,
                       device: DeviceLike = None
                       ) -> Tuple[int, Params, OptState]:
    """The newest step under ``path``: ``(step, params, opt_state)`` placed
    like the templates (device and dtype of each leaf); a leaf whose shape
    differs from its template raises.

    The templates may be concrete or ``abstract_train_state``'s ``meta``
    trees, whose leaves are allocated on ``mesh.device`` (or ``device``,
    None = CUDA, without a mesh). On a ``mesh`` the templates hold this
    rank's local shapes and each rank assembles its own blocks from the
    saved ones, whatever mesh (or single device) wrote them — under pp its
    stage's layers, found by their global indices: the files are
    memory-mapped, so no rank reads the whole tree."""
    found = _checkpoints(Path(path))
    if not found:
        raise FileNotFoundError(f"no checkpoint under {path}")
    step = max(found)
    sources, count = _sources(found[step])
    first_layer = _first_layer(params_like, mesh)

    def restore(prefix: str, tree: Any) -> Any:
        return _unflatten(tree, [
            _restore_leaf(f"{prefix}/{_global_path(leaf_path, first_layer)}",
                          name, like, sources, mesh, device)
            for leaf_path, name, like in zip(leaf_paths(tree),
                                             leaf_names(tree),
                                             tree_leaves(tree))])

    return step, restore("params", params_like), {
        "count": count, "mu": restore("mu", opt_state_like["mu"]),
        "nu": restore("nu", opt_state_like["nu"])}


# -- loop ----------------------------------------------------------------------

def train_loop(model_config: TransformerConfig, train_config: TrainConfig,
               mesh: Any = None, num_steps: int = 10, seed: int = 0,
               log_every: int = 10, telemetry: Any = None,
               sync_every: int = 1,
               batches: Optional[Iterator[torch.Tensor]] = None,
               loss_fn: Callable = TransformerLM.loss,
               device: DeviceLike = None) -> Dict[str, float]:
    """Init from ``seed``, run ``num_steps`` steps and return the last
    metrics with the steady step time. Batches come from ``batches`` when
    given, else synthetic data from a generator seeded ``seed + 1``.

    ``sync_every``: wait for the device only every N steps, as a real loop
    enqueues steps back to back; the step time is then wall-clock over each
    N-step window (``_steady_step_time``). ``telemetry`` (a
    ``telemetry.TelemetryEmitter``) gets ``sample(step_time_s=...)`` once
    per window, as in JAX.

    On a ``mesh`` every rank runs the loop on ``mesh.device``: ``batches``
    yields the rank's rows (``data.prefetch_to_device(..., mesh=mesh)``);
    a synthetic batch is drawn whole from the shared seed and each rank
    keeps its rows. The metrics are the same on every rank; only rank 0
    samples ``telemetry``."""
    if mesh is None:
        device = resolve_device(device)
    else:
        device = _mesh_device(mesh, device)
    params, opt_state = init_train_state(
        model_config, train_config,
        torch.Generator(device=device).manual_seed(seed), device, mesh)
    data = torch.Generator(device=device).manual_seed(seed + 1)
    step_fn = make_train_step(model_config, train_config, mesh,
                              loss_fn=loss_fn)
    samples = telemetry is not None and (mesh is None or mesh.rank == 0)
    window_times: List[Tuple[float, bool]] = []
    metrics_dev: Dict[str, torch.Tensor] = {}
    window_start = time.perf_counter()
    window_len = 0
    last_logged = 0
    for step_index in range(num_steps):
        if batches is not None:
            try:
                tokens = next(batches)
            except StopIteration:
                raise ValueError(
                    f"batches iterator exhausted at step {step_index} of "
                    f"{num_steps}") from None
        else:
            tokens = synthetic_batch(data, train_config,
                                     model_config.vocab_size, device)
            if mesh is not None:
                rows = train_config.batch_size // mesh.data_size
                tokens = tokens[mesh.data_rank * rows:
                                (mesh.data_rank + 1) * rows]
        params, opt_state, metrics_dev = step_fn(params, opt_state, tokens)
        window_len += 1
        if window_len >= sync_every or step_index == num_steps - 1:
            loss_value = float(metrics_dev["loss"])   # a device->host read
            now = time.perf_counter()
            per_step = (now - window_start) / window_len
            window_times.append((per_step, window_len >= sync_every))
            if samples:
                telemetry.sample(step_time_s=per_step)
            if log_every and (step_index + 1) - last_logged >= log_every:
                log.info("step %d loss=%.4f (%.1f ms)", step_index + 1,
                         loss_value, per_step * 1e3)
                last_logged = step_index + 1
            window_start = now
            window_len = 0
    metrics = {key: float(value) for key, value in metrics_dev.items()}
    step_time, rejected = _steady_step_time(window_times)
    metrics["rejected_windows"] = float(rejected)
    metrics["step_time_s"] = step_time
    metrics["steps_per_sec"] = 1.0 / step_time
    return metrics


def _steady_step_time(window_times: List[Tuple[float, bool]]
                      ) -> Tuple[float, int]:
    """(median steady per-step seconds, windows rejected as stalls) from
    (per-step seconds, is_full_window) windows: drop the first window (it
    holds start-up) and trailing partial windows, then reject windows more
    than 3x the fastest as stalls."""
    steady = [t for t, full in window_times[1:] if full] \
        or [t for t, _ in window_times[1:]] \
        or [t for t, _ in window_times]
    floor = min(steady)
    kept = [t for t in steady if t <= 3.0 * floor]
    return sorted(kept)[len(kept) // 2], len(steady) - len(kept)
