"""Decoder-only transformer LM — the PyTorch counterpart of
``tensorhive_tpu/models/transformer.py`` (inference half).

Same architecture and the same parameter tree as the JAX model, so weights
made by ``TransformerLM.init`` on either side describe the same function:

* pre-RMSNorm (eps 1e-6, computed in f32), interleaved RoPE, SwiGLU MLP;
* weights in the JAX ``[in, out]`` layout, applied as ``x @ w`` (no
  ``nn.Linear``, which would store every weight transposed);
* params are a plain dict mirroring the JAX pytree: ``tok_embed``,
  ``final_norm.scale``, ``w_lm_head`` and ``blocks[i]`` with
  ``attn_norm``/``mlp_norm``/``wq``/``wk``/``wv``/``wo``/``w_in``/
  ``w_gate``/``w_out``.

Weights are cast to ``config.dtype`` at use, as the JAX model's
``.astype(dtype)`` does: serving weights already are in ``config.dtype``
(``init`` and ``convert.params_from_jax`` make them so by default, and a
bf16 model reads half the weight bytes), so the cast is a no-op there;
training keeps f32 masters (``param_dtype=torch.float32``) and gets f32
gradients through the cast. Norm scales stay f32, as ``_rmsnorm`` uses
them.

Training: ``loss`` (full or chunked cross entropy; ``_chunked_ce`` takes
per-token weights, which the MLM loss of ``models/encoder`` passes), the
``remat`` policies
("block" checkpoints whole blocks, "mlp" only the MLP half) through
``torch.utils.checkpoint``, and ``train_flops_per_token``. Serving under a
tensor-parallel mesh runs the block functions on a rank's weight shard,
with ``reduce`` hooks for the row-parallel sums (``parallel/mesh.py``).
Training under a ``pp x dp x fsdp x tp x sp`` mesh (``apply_trunk``/
``apply``/``loss`` with ``mesh``) adds the ``gather`` hook (each leaf's
fsdp blocks assembled inside the function that reads it) and the ``copy``
hook (the tp sum of the input's gradient), and takes the vocab-parallel
embedding and cross entropy of ``parallel/train_parallel.py``; each rank
runs the flash kernels at its local head counts. Under sp a rank holds
its block of the sequence and attends through ``parallel/ring.py``; under
pp its stage's layers run as a stage of ``parallel/pipeline.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..ops.flash_attention import flash_attention
from ..parallel.pipeline import pipeline_apply, pp_enabled
from ..parallel.ring import ring_attention
from ..parallel.train_parallel import TrainParallel

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 1408
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16   # activation/matmul dtype
    rope_theta: float = 10_000.0
    #: recompute activations in the backward (training only)
    remat: bool = True
    #: what ``remat`` recomputes: "block" checkpoints whole blocks (the
    #: backward re-runs everything, the flash forward included); "mlp"
    #: checkpoints only the MLP half, so q/k/v and the flash O/LSE stay
    #: saved and the backward never re-runs the flash forward
    remat_policy: str = "block"
    #: token-chunk size of the memory-lean CE loss (0 disables); engaged
    #: only when the full logits would pass ``_chunk_threshold_bytes``
    loss_chunk_tokens: int = 16_384
    #: grouped-query attention: number of K/V heads (None = n_heads)
    n_kv_heads: Optional[int] = None
    causal: bool = True
    #: b·h rows per program of the head-blocked flash forward (the JAX
    #: ``TPUHIVE_FLASH_BH_BLOCK``; 1 = off, the JAX default). Clamped by
    #: ``ops.flash_attention.fwd_bh_block``, so GQA configs stay at 1
    flash_bh_block: int = 1
    #: pipeline microbatches when the mesh has pp > 1 (0 = one per stage);
    #: more microbatches shrink the (pp-1)/(M+pp-1) bubble at the cost of
    #: smaller per-step matmuls
    pp_microbatches: int = 0

    @property
    def d_head(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be a multiple of n_heads")
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_kv_heads or self.n_heads
        if self.n_heads % kv:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        return kv


#: the JAX package's presets, at the same widths
PRESETS: Dict[str, TransformerConfig] = {
    "tiny": TransformerConfig(vocab_size=512, d_model=64, n_heads=4, n_layers=2,
                              d_ff=176, max_seq_len=256),
    "t2t-base": TransformerConfig(vocab_size=32_000, d_model=512, n_heads=8,
                                  n_layers=6, d_ff=2048, max_seq_len=2048),
    "t2t-big": TransformerConfig(vocab_size=32_000, d_model=1024, n_heads=16,
                                 n_layers=6, d_ff=4096, max_seq_len=2048),
    "1b": TransformerConfig(vocab_size=32_000, d_model=2048, n_heads=16,
                            n_layers=16, d_ff=5632, max_seq_len=4096),
    # Llama-7B-class dims, GQA-8: ~5.9 B parameters, ~12 GB in bf16 — one
    # H100 holds it whole, with room for the paged KV pool
    "7b": TransformerConfig(vocab_size=32_000, d_model=4096, n_heads=32,
                            n_layers=32, d_ff=11_008, max_seq_len=4096,
                            n_kv_heads=8, remat_policy="mlp"),
}

#: chunk the CE loss past this many logits bytes where the device cannot
#: report its memory (the CPU)
CHUNKED_LOSS_THRESHOLD_BYTES = 2 << 30
REMAT_POLICIES = ("block", "mlp")


@functools.lru_cache(maxsize=None)
def _chunk_threshold_bytes(device: torch.device) -> int:
    """Logits bytes past which the loss chunks: 0.7 of the card's memory
    (``torch.cuda.mem_get_info``), 2 GiB on the CPU — the JAX rule, which
    keeps the full-logits path wherever it still fits."""
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        return int(total * 0.7)
    return CHUNKED_LOSS_THRESHOLD_BYTES


def _loss_chunk(n_tokens: int, config: "TransformerConfig",
                device: torch.device, vocab_shards: int = 1) -> int:
    """Token-chunk size of the chunked CE path, or 0 for the full-logits
    path. The chunk shrinks to a divisor of ``n_tokens`` (gcd) so awkward
    batches still chunk. Under a mesh ``n_tokens`` is the rank's and the
    vocab is cut in ``vocab_shards`` (tp): the rank's logits shard is what
    is held against the threshold, as JAX does."""
    if not config.loss_chunk_tokens:
        return 0
    if (n_tokens * config.vocab_size * 4 // vocab_shards
            <= _chunk_threshold_bytes(device)):
        return 0
    return math.gcd(n_tokens, config.loss_chunk_tokens)


def _lse_minus_target(logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy as logsumexp - target logit [..., L],
    without a log-probability tensor."""
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return lse - target_logit


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim of [B, L, H, D], INTERLEAVED: the
    pairs are ``(x[..., 0::2], x[..., 1::2])`` and the rotated halves are
    re-interleaved — not the half-split layout of common Llama ports."""
    d = x.shape[-1]
    exponent = -torch.arange(0, d, 2, dtype=torch.float32,
                             device=x.device) / d
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exponent)
    angles = positions[:, :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.reshape(x.shape).to(x.dtype)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    norm = x.to(torch.float32)
    norm = norm * torch.rsqrt(torch.mean(norm * norm, dim=-1, keepdim=True)
                              + 1e-6)
    return (norm * scale.to(torch.float32)).to(x.dtype)


def _lm_head(x: torch.Tensor, w_head: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Logits in f32 from operands rounded to ``dtype`` (``config.dtype``):
    the JAX head's ``jnp.dot(x.astype(dtype), w.astype(dtype),
    preferred_element_type=f32)``. Widening both rounded operands to f32 is
    exact, so this is the same product with f32 accumulation and an f32
    result (a bf16 matmul would round the logits to bf16). An f32 master
    head is rounded to ``dtype`` first."""
    return (x.to(dtype).to(torch.float32)
            @ w_head.to(dtype).to(torch.float32))


def _chunked_ce(x_flat: torch.Tensor, targets_flat: torch.Tensor,
                w_head: torch.Tensor, dtype: torch.dtype,
                chunk_tokens: int,
                weights_flat: Optional[torch.Tensor] = None,
                par: Optional[TrainParallel] = None) -> torch.Tensor:
    """Sum of weight * (logsumexp - target logit) over all tokens, one
    token chunk at a time (``weights_flat`` None = unweighted; the MLM loss
    passes its mask). Each chunk runs under ``torch.utils.checkpoint``, so
    the backward recomputes its logits instead of keeping them: peak memory
    is one [chunk, vocab] f32 buffer either way.

    On a training mesh (``par``) the sum is over this rank's tokens, from
    its vocab columns of the head through the vocab-parallel CE (the whole
    logits are never assembled), and ``chunk_tokens`` 0 takes all of them
    at once."""
    if weights_flat is None:
        weights_flat = torch.ones(x_flat.shape[0], dtype=torch.float32,
                                  device=x_flat.device)
    weights_flat = weights_flat.to(torch.float32)
    if par is not None:
        x_flat = par.copy(x_flat)
        w_head = par.gather(w_head, "w_lm_head")

    def one_chunk(x_blk, t_blk, w_blk):
        logits = _lm_head(x_blk, w_head, dtype)
        per_token = (_lse_minus_target(logits, t_blk) if par is None
                     else par.cross_entropy(logits, t_blk))
        return torch.sum(per_token * w_blk)

    if not chunk_tokens:
        return one_chunk(x_flat, targets_flat, weights_flat)
    sums = [checkpoint(one_chunk, x_blk, t_blk, w_blk, use_reentrant=False)
            for x_blk, t_blk, w_blk in zip(x_flat.split(chunk_tokens),
                                           targets_flat.split(chunk_tokens),
                                           weights_flat.split(chunk_tokens))]
    return torch.stack(sums).sum()


#: the mark a train step hands ``loss`` on this thread (``marking_head``)
_head_marks = threading.local()


@contextlib.contextmanager
def marking_head(mark: Callable[[torch.Tensor], None]) -> Iterator[None]:
    """Within: ``TransformerLM.loss`` calls ``mark(x)`` with the trunk's
    output as it enters the head, on each of its paths (the train step's
    trunk/head phase boundary, ``train.StepPhases``). ``mark`` must leave
    ``x`` as it is."""
    _head_marks.mark = mark
    try:
        yield
    finally:
        _head_marks.mark = None


def _enter_head(x: torch.Tensor) -> torch.Tensor:
    """``x``, handed to the mark of ``marking_head`` if one is set."""
    mark = getattr(_head_marks, "mark", None)
    if mark is not None:
        mark(x)
    return x


Attend = Callable[..., torch.Tensor]
#: a row-parallel partial sum -> the sum over the tensor-parallel ranks
Reduce = Callable[[torch.Tensor], torch.Tensor]
#: a training mesh's ``gather(shard, leaf name)`` -> the whole leaf; and
#: its ``copy``, the identity whose backward sums over the tp ranks
Gather = Callable[[torch.Tensor, str], torch.Tensor]
Copy = Callable[[torch.Tensor], torch.Tensor]


def _as_is(leaf: torch.Tensor, name: str) -> torch.Tensor:
    return leaf


class TransformerLM(nn.Module):
    """The model as a module over a plain param dict, plus the JAX
    package's ``init`` / ``apply`` / block functions as static methods.

    ``TransformerLM(config, device=None)`` makes random params with
    ``init`` on the device (``None`` = ``cuda``); ``forward`` is
    ``apply``."""

    def __init__(self, config: TransformerConfig,
                 params: Optional[Params] = None, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None) -> None:
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        self.params = (params if params is not None else
                       TransformerLM.init(config, generator, self.device))

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        return TransformerLM.apply(self.params, tokens, self.config,
                                   positions=positions)

    # -- init ---------------------------------------------------------------
    @staticmethod
    def init(config: TransformerConfig,
             generator: Optional[torch.Generator] = None,
             device: DeviceLike = None,
             param_dtype: Optional[torch.dtype] = None,
             shard: Optional[Callable[[torch.Tensor, str], torch.Tensor]]
             = None, layers: Optional[range] = None) -> Params:
        """Random params with the JAX init's distributions
        (``transformer.py:229-257``): embedding N(0, 0.02²), dense weights
        N(0, 1/fan_in), norm scales 1. The draws come from ``generator``
        (default: seed 0 on the device), so they are NOT the JAX draws —
        parity tests carry JAX-made weights across with ``convert``.
        Matmul weights and the embedding are stored in ``param_dtype``
        (default ``config.dtype``; training passes f32 masters). On the
        ``meta`` device the tree has shapes and dtypes and no values.
        ``shard(leaf, name)`` (a training mesh's block of a leaf) is applied
        to each leaf as it is drawn, so the whole tree is never held: the
        draws stay the same, whatever the mesh. ``layers`` (a pp stage's
        global layer indices) keeps only those blocks; every layer is
        still drawn, in order."""
        device = resolve_device(device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        dtype = config.dtype if param_dtype is None else param_dtype

        keep = shard or _as_is

        def normal(std: float, name: str, *shape: int) -> torch.Tensor:
            values = torch.randn(shape, generator=generator, device=device,
                                 dtype=torch.float32)
            return keep((values * std).to(dtype), name)

        def dense(fan_in: int, name: str, *shape: int) -> torch.Tensor:
            return normal(1.0 / math.sqrt(fan_in), name, *shape)

        def ones(size: int) -> Dict[str, torch.Tensor]:
            return {"scale": keep(torch.ones(size, dtype=torch.float32,
                                             device=device), "scale")}

        d, h, dh, f = (config.d_model, config.n_heads, config.d_head,
                       config.d_ff)
        kv = config.kv_heads
        params: Params = {
            "tok_embed": normal(0.02, "tok_embed", config.vocab_size, d),
            "final_norm": ones(d),
            "w_lm_head": dense(d, "w_lm_head", d, config.vocab_size),
            "blocks": [],
        }
        for index in range(config.n_layers):
            block = {
                "attn_norm": ones(d),
                "mlp_norm": ones(d),
                "wq": dense(d, "wq", d, h * dh),
                "wk": dense(d, "wk", d, kv * dh),
                "wv": dense(d, "wv", d, kv * dh),
                "wo": dense(h * dh, "wo", h * dh, d),
                "w_in": dense(d, "w_in", d, f),
                "w_gate": dense(d, "w_gate", d, f),
                "w_out": dense(f, "w_out", f, d),
            }
            if layers is None or index in layers:
                params["blocks"].append(block)
        return params

    @staticmethod
    def param_count(params: Params) -> int:
        count = params["tok_embed"].numel() + params["w_lm_head"].numel()
        count += params["final_norm"]["scale"].numel()
        for block in params["blocks"]:
            for value in block.values():
                count += (value["scale"].numel() if isinstance(value, dict)
                          else value.numel())
        return count

    # -- forward ------------------------------------------------------------
    @staticmethod
    def block_attn_half(x, block, config: TransformerConfig, positions,
                        attend: Attend,
                        layer_index: Optional[int] = None,
                        reduce: Optional[Reduce] = None,
                        copy: Optional[Copy] = None,
                        gather: Optional[Gather] = None) -> torch.Tensor:
        """Pre-norm QKV + rope + ``attend`` + output projection, residual
        added. ``attend(q, k, v)`` — or ``attend(q, k, v, layer_index)``
        when the caller passes ``layer_index`` (cache-writing strategies).
        Head counts come from the weights, so a tensor-parallel rank's
        shard (``wq``/``wk``/``wv`` columns of its heads) runs its local
        heads; ``reduce`` then sums its row-parallel ``attn @ wo`` over the
        ranks before the residual add. In training on a mesh ``gather``
        assembles each leaf's fsdp blocks and ``copy`` stands before the
        column-parallel products."""
        dtype = config.dtype
        gather = gather or _as_is
        h = _rmsnorm(x, gather(block["attn_norm"]["scale"], "scale"))
        if copy is not None:
            h = copy(h)
        b, length, _ = h.shape
        d_head = config.d_head
        heads = block["wq"].shape[-1] // d_head
        kv_heads = block["wk"].shape[-1] // d_head
        q = (h @ gather(block["wq"], "wq").to(dtype)
             ).reshape(b, length, heads, d_head)
        k = (h @ gather(block["wk"], "wk").to(dtype)
             ).reshape(b, length, kv_heads, d_head)
        v = (h @ gather(block["wv"], "wv").to(dtype)
             ).reshape(b, length, kv_heads, d_head)
        q = _rope(q, positions, config.rope_theta)
        k = _rope(k, positions, config.rope_theta)
        attn = (attend(q, k, v) if layer_index is None
                else attend(q, k, v, layer_index))
        attn = attn.reshape(b, length, heads * d_head)
        out = attn @ gather(block["wo"], "wo").to(dtype)
        return x + (out if reduce is None else reduce(out))

    @staticmethod
    def block_mlp_half(x, block, config: TransformerConfig,
                       reduce: Optional[Reduce] = None,
                       copy: Optional[Copy] = None,
                       gather: Optional[Gather] = None) -> torch.Tensor:
        """SwiGLU MLP half of a block, residual added; ``reduce`` sums a
        tensor-parallel rank's row-parallel ``gated @ w_out`` (``copy``
        and ``gather`` as in ``block_attn_half``)."""
        dtype = config.dtype
        gather = gather or _as_is
        h = _rmsnorm(x, gather(block["mlp_norm"]["scale"], "scale"))
        if copy is not None:
            h = copy(h)
        gated = (F.silu(h @ gather(block["w_gate"], "w_gate").to(dtype))
                 * (h @ gather(block["w_in"], "w_in").to(dtype)))
        out = gated @ gather(block["w_out"], "w_out").to(dtype)
        return x + (out if reduce is None else reduce(out))

    @staticmethod
    def block_forward(x, block, config: TransformerConfig, positions,
                      attend: Attend,
                      layer_index: Optional[int] = None,
                      reduce_attn: Optional[Reduce] = None,
                      reduce_mlp: Optional[Reduce] = None,
                      copy: Optional[Copy] = None,
                      gather: Optional[Gather] = None) -> torch.Tensor:
        """One block — the single copy of the block math that prefill,
        decode and ``apply`` share, each with its own ``attend``."""
        x = TransformerLM.block_attn_half(x, block, config, positions, attend,
                                          layer_index=layer_index,
                                          reduce=reduce_attn, copy=copy,
                                          gather=gather)
        return TransformerLM.block_mlp_half(x, block, config,
                                            reduce=reduce_mlp, copy=copy,
                                            gather=gather)

    @staticmethod
    def apply_trunk(params: Params, tokens: torch.Tensor,
                    config: TransformerConfig,
                    positions: Optional[torch.Tensor] = None,
                    mesh: Any = None) -> torch.Tensor:
        """Everything before the LM head: normed activations
        [B, L, d_model] in ``config.dtype``. Under autograd with
        ``config.remat`` the blocks are checkpointed by ``remat_policy``.
        On a training ``mesh`` (``parallel.mesh.train_mesh``) ``params``
        is this rank's shard and ``tokens`` its rows: the blocks gather
        each leaf inside their (checkpointed) function, so a recomputed
        block gathers again rather than keeping whole weights alive. Under
        sp the rank embeds its block of the sequence (RoPE at the block's
        global positions), attends through the ring and returns that block,
        [B, L / sp, d_model]; under pp its stage's layers run as one stage
        of the pipeline and every stage returns the finished activations."""
        if config.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                             f"got {config.remat_policy!r}")
        if positions is None:
            positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=tokens.device
                                     ).expand(tokens.shape)
        # the mesh's hooks of the block functions (none on one device)
        reduce: Optional[Reduce] = None
        copy: Optional[Copy] = None
        gather: Gather = _as_is
        pipelined = pp_enabled(mesh)
        if pipelined:
            stage = mesh.stage_layers(config.n_layers)
            if len(params["blocks"]) != len(stage):
                raise ValueError(
                    f"a pp rank holds its stage's {len(stage)} layers, got "
                    f"{len(params['blocks'])}")
        if mesh is None:
            x = params["tok_embed"].to(config.dtype)[tokens.long()]
        else:
            par = TrainParallel(mesh)
            reduce, copy, gather = par.reduce, par.copy, par.gather
            tokens = par.seq_block(tokens)
            positions = par.seq_block(positions)
            x = par.embed(params["tok_embed"], tokens, config.dtype)
        ring = mesh is not None and mesh.sp > 1

        def attend(q, k, v):
            # GQA is native in the kernels (KV head h // group, no expanded
            # copy); the plain versions on CPU tensors expand internally
            if ring:
                return ring_attention(q, k, v, mesh, causal=config.causal)
            return flash_attention(q, k, v, causal=config.causal,
                                   bh_block=config.flash_bh_block)

        def plain_block(x, block, positions):
            return TransformerLM.block_forward(
                x, block, config, positions, attend, reduce_attn=reduce,
                reduce_mlp=reduce, copy=copy, gather=gather)

        def remat_block(x, block, positions):
            return checkpoint(plain_block, x, block, positions,
                              use_reentrant=False)

        def remat_mlp(x, block, positions):
            # the attention half's activations, the flash O/LSE residuals
            # included, stay saved: the backward re-runs only the MLP half
            x = TransformerLM.block_attn_half(
                x, block, config, positions, attend, reduce=reduce,
                copy=copy, gather=gather)
            return checkpoint(TransformerLM.block_mlp_half, x, block, config,
                              reduce=reduce, copy=copy, gather=gather,
                              use_reentrant=False)

        block_fn = plain_block
        if config.remat and torch.is_grad_enabled():
            block_fn = (remat_mlp if config.remat_policy == "mlp"
                        else remat_block)

        def apply_blocks(x, positions):
            for block in params["blocks"]:
                x = block_fn(x, block, positions)
            return x

        if pipelined:
            anchors = [leaf for block in params["blocks"]
                       for leaf in block.values()
                       if isinstance(leaf, torch.Tensor)]
            x = pipeline_apply(apply_blocks, par.stage_shared(x), positions,
                               mesh, config.pp_microbatches, anchors)
        else:
            x = apply_blocks(x, positions)
        return _rmsnorm(x, gather(params["final_norm"]["scale"], "scale"))

    @staticmethod
    def apply(params: Params, tokens: torch.Tensor,
              config: TransformerConfig,
              positions: Optional[torch.Tensor] = None,
              mesh: Any = None) -> torch.Tensor:
        """Logits [B, L, vocab] in f32 (on a training ``mesh``: of this
        rank's rows and, under sp, its block of the sequence, assembled
        over tp)."""
        x = TransformerLM.apply_trunk(params, tokens, config,
                                      positions=positions, mesh=mesh)
        if mesh is None:
            return _lm_head(x, params["w_lm_head"], config.dtype)
        par = TrainParallel(mesh)
        return par.logits(_lm_head(par.copy(x), par.gather(
            params["w_lm_head"], "w_lm_head"), config.dtype))

    # -- loss ---------------------------------------------------------------
    @staticmethod
    def loss(params: Params, tokens: torch.Tensor, config: TransformerConfig,
             mesh: Any = None) -> torch.Tensor:
        """Next-token cross entropy, mean over tokens (f32). ``tokens`` is
        [B, L+1]: inputs and shifted targets. On a training ``mesh``
        ``params`` is this rank's shard and ``tokens`` its rows of the
        global batch (the whole sequence: under sp each rank takes its
        block of the inputs and of the targets, cut after the shift, so
        target ``p`` is still token ``p + 1``); the loss is the global
        mean, the same on every rank. On every path the trunk's output
        enters the head through ``_enter_head``."""
        if not config.causal:
            # bidirectional attention lets position p see token p+1, its
            # own target: the next-token loss would train a copy-through
            raise ValueError(
                "TransformerLM.loss is the autoregressive objective; this "
                "config is a bidirectional encoder (causal=False)")
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        if mesh is not None:
            par = TrainParallel(mesh)
            targets = par.seq_block(targets)
            n_tokens = targets.numel()
            x = _enter_head(TransformerLM.apply_trunk(params, inputs, config,
                                                      mesh=mesh))
            total = _chunked_ce(
                x.reshape(n_tokens, -1), targets.reshape(n_tokens),
                params["w_lm_head"], config.dtype,
                _loss_chunk(n_tokens, config, tokens.device, mesh.tp),
                par=par)
            return par.data_sum(total) / (n_tokens * mesh.data_size
                                          * mesh.sp)
        n_tokens = targets.shape[0] * targets.shape[1]
        chunk = _loss_chunk(n_tokens, config, tokens.device)
        x = _enter_head(TransformerLM.apply_trunk(params, inputs, config))
        if chunk:
            total = _chunked_ce(x.reshape(n_tokens, -1),
                                targets.reshape(n_tokens),
                                params["w_lm_head"], config.dtype, chunk)
            return total / n_tokens
        logits = _lm_head(x, params["w_lm_head"], config.dtype)
        return torch.mean(_lse_minus_target(logits, targets))


def train_flops_per_token(config: TransformerConfig, seq_len: int,
                          remat: bool = False) -> float:
    """Analytic model FLOPs per trained token (matmuls only), for MFU — the
    JAX formula: forward Q+O projections 4·D², K+V 4·D·Hkv·Dh, SwiGLU
    6·D·F, attention core 2·2·S·D halved by causality, LM head 2·D·V;
    training 3x forward, and remat re-runs each block's forward once more
    (not the head)."""
    d, f, v = config.d_model, config.d_ff, config.vocab_size
    kv_dim = config.kv_heads * config.d_head
    attn_core = (2 if config.causal else 4) * seq_len * d
    per_layer = 4 * d * d + 4 * d * kv_dim + 6 * d * f + attn_core
    fwd = config.n_layers * per_layer + 2 * d * v
    if remat:
        return 4.0 * config.n_layers * per_layer + 3.0 * 2 * d * v
    return 3.0 * fwd
