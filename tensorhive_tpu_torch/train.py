"""Training: optimizer, train step, loop, checkpoints, synthetic data — the
PyTorch counterpart of ``tensorhive_tpu/train.py`` on one device.

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
  ``max_to_keep``.

Params and gradients are the plain param dict of ``models/transformer``.
The mesh arguments of the JAX functions (sharded params and batches) are
refused as not yet ported. Entry points that make tensors take
``device=None``, which means CUDA and raises without a card.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import re
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from .device import DeviceLike, resolve_device
from .models.transformer import Params, TransformerConfig, TransformerLM

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


def _refuse_mesh(mesh: Any) -> None:
    if mesh is not None:
        raise ValueError("mesh (sharded training) is not yet ported")


# -- param trees ---------------------------------------------------------------

def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Tensors of a nested dict/list tree, in a fixed order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


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
    def update(self, grads: Params, state: OptState,
               params: Params) -> OptState:
        """Apply one step to ``params`` in place; returns the new state
        (its moments updated in place)."""
        grad_leaves = tree_leaves(grads)
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
    state."""
    _refuse_mesh(mesh)
    device = resolve_device(device)
    params = TransformerLM.init(model_config, generator, device,
                                param_dtype=torch.float32)
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
    them syncs)."""
    _refuse_mesh(mesh)
    optimizer = make_optimizer(train_config)
    accum = train_config.grad_accum_steps
    if accum < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {accum}")
    if accum > 1 and train_config.batch_size % accum:
        raise ValueError(
            f"batch_size {train_config.batch_size} not divisible by "
            f"grad_accum_steps {accum}")

    def value_and_grad(params: Params, tokens: torch.Tensor
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(live, tokens, model_config)
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
        micro = train_config.batch_size // accum
        for micro_batch in tokens.reshape(accum, micro, *tokens.shape[1:]):
            loss, grads = value_and_grad(params, micro_batch)
            loss_sum += loss
            for total, grad in zip(sums, grads):
                total += grad.to(torch.float32)
        scale = 1.0 / accum
        return loss_sum * scale, [total * scale for total in sums]

    def step(params: Params, opt_state: OptState, tokens: torch.Tensor
             ) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
        loss, grad_leaves = loss_and_grads(params, tokens)
        grad_norm = global_norm(grad_leaves)
        grads = _unflatten(params, grad_leaves)
        opt_state = optimizer.update(grads, opt_state, params)
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


def _checkpoint_steps(path: Path) -> List[int]:
    if not path.is_dir():
        return []
    return sorted(int(match.group(1)) for match in
                  map(_CHECKPOINT.match, os.listdir(path)) if match)


def save_checkpoint(path: str, step: int, params: Params, opt_state: OptState,
                    max_to_keep: int = 3) -> None:
    """Write ``path/step_<step>.pt`` (atomically: a temporary file, then a
    rename) and delete all but the newest ``max_to_keep`` steps."""
    directory = Path(path)
    directory.mkdir(parents=True, exist_ok=True)
    target = directory / f"step_{step:010d}.pt"
    partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    torch.save({"step": step, "params": params, "opt_state": opt_state},
               partial)
    os.replace(partial, target)
    for old in _checkpoint_steps(directory)[:-max_to_keep]:
        (directory / f"step_{old:010d}.pt").unlink()


def restore_checkpoint(path: str, params_like: Params,
                       opt_state_like: OptState
                       ) -> Tuple[int, Params, OptState]:
    """The newest step under ``path``: ``(step, params, opt_state)`` placed
    like the templates (device and dtype of each leaf); a leaf whose shape
    differs from its template raises."""
    steps = _checkpoint_steps(Path(path))
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {path}")
    saved = torch.load(Path(path) / f"step_{steps[-1]:010d}.pt",
                       map_location="cpu", weights_only=True)

    def place(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if value.shape != like.shape:
            raise ValueError(f"checkpoint leaf {tuple(value.shape)} does not "
                             f"match the template {tuple(like.shape)}")
        return value.to(device=like.device, dtype=like.dtype)

    params = tree_map(place, saved["params"], params_like)
    opt_state = {"count": int(saved["opt_state"]["count"]),
                 "mu": tree_map(place, saved["opt_state"]["mu"],
                                opt_state_like["mu"]),
                 "nu": tree_map(place, saved["opt_state"]["nu"],
                                opt_state_like["nu"])}
    return saved["step"], params, opt_state


# -- loop ----------------------------------------------------------------------

def train_loop(model_config: TransformerConfig, train_config: TrainConfig,
               mesh: Any = None, num_steps: int = 10, seed: int = 0,
               log_every: int = 10, sync_every: int = 1,
               batches: Optional[Iterator[torch.Tensor]] = None,
               loss_fn: Callable = TransformerLM.loss,
               device: DeviceLike = None) -> Dict[str, float]:
    """Init from ``seed``, run ``num_steps`` steps and return the last
    metrics with the steady step time. Batches come from ``batches`` when
    given, else synthetic data from a generator seeded ``seed + 1``.

    ``sync_every``: wait for the device only every N steps, as a real loop
    enqueues steps back to back; the step time is then wall-clock over each
    N-step window (``_steady_step_time``)."""
    _refuse_mesh(mesh)
    device = resolve_device(device)
    params, opt_state = init_train_state(
        model_config, train_config,
        torch.Generator(device=device).manual_seed(seed), device)
    data = torch.Generator(device=device).manual_seed(seed + 1)
    step_fn = make_train_step(model_config, train_config, loss_fn=loss_fn)
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
        params, opt_state, metrics_dev = step_fn(params, opt_state, tokens)
        window_len += 1
        if window_len >= sync_every or step_index == num_steps - 1:
            loss_value = float(metrics_dev["loss"])   # a device->host read
            now = time.perf_counter()
            per_step = (now - window_start) / window_len
            window_times.append((per_step, window_len >= sync_every))
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
