"""Serving and training meshes of the port — the PyTorch counterpart of
``tensorhive_tpu/parallel/mesh.py``, over ``torch.distributed``.

The JAX package shards a serving engine with one controller and GSPMD: a
``jax.sharding.Mesh`` of ``dp x tp`` devices, a ``MeshRules`` vocabulary
that maps each parameter's logical axes onto mesh axes, and XLA inserting
the collectives. The port runs one process per rank instead (SPMD): rank
``r`` of a ``dp x tp`` mesh sits at ``(dp_rank, tp_rank) = (r // tp,
r % tp)`` — the position of device ``r`` in JAX's ``make_mesh`` layout —
holds the contiguous ``tp_rank``-th block of every tp-sharded weight axis
(:func:`shard_serving_params`, JAX's ``tree_shardings`` shard for that
device byte for byte), and issues the collectives GSPMD would, by hand
(:class:`TensorParallel`): the row-parallel partial sums of ``attn @ wo``
and ``gated @ w_out``, the vocab-sharded embedding lookup, and the
vocab-sharded logits.

Copied in meaning from the JAX module: ``MeshRules``, ``DEFAULT_RULES``,
``_PARAM_LOGICAL``, ``best_mesh_shape``, ``serving_rules`` (the GQA
guard), ``normalized_spec``, ``serving_cache_spec`` and
``serving_scale_spec``. A spec here is a plain tuple of mesh-axis names
(``None`` = whole), not a ``PartitionSpec``; it says which axis of a
tensor this rank holds a slice of (:func:`local_shape`).

Both collectives are ``all_reduce`` — the one collective, beside
``broadcast``, that gloo runs on CUDA tensors — so one code path serves
gloo (every rank on one card, or the CPU) and NCCL (a card per rank):
:func:`tp_all_reduce` sums in f32 and :func:`tp_assemble` scatters each
rank's block into a zero-filled buffer that the sum fills. Both are the
identity at tp 1.

The training mesh (:func:`train_mesh`, ``dp x fsdp x tp``) lays ranks out
the same way over JAX's training axes: :func:`shard_train_params` keeps
each rank's block of every leaf by ``DEFAULT_RULES`` (``embed`` over fsdp,
the rest over tp, no GQA guard), and ``train_parallel.py`` holds its
collectives.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

Spec = Tuple[Optional[str], ...]


def best_mesh_shape(n_devices: int, seq_parallel: bool = False,
                    kv_heads: Optional[int] = None) -> Dict[str, int]:
    """Heuristic default mesh for n devices: fsdp-dominant, with a modest
    tp factor once the slice is large, and an sp factor when long context
    is asked for. Factors are only taken when they divide n, so the product
    always equals ``n_devices``. ``kv_heads`` caps the chosen tp at the
    model's K/V head count, halving it until it divides ``kv_heads`` (a
    tp past the K/V heads forces the GQA guard of :func:`serving_rules`)."""
    sizes = {"dp": 1, "fsdp": n_devices, "tp": 1, "sp": 1}
    if seq_parallel:
        sp = 4 if n_devices >= 16 and n_devices % 4 == 0 else \
            2 if n_devices % 2 == 0 else 1
        sizes["sp"] = sp
        sizes["fsdp"] = n_devices // sp
    else:
        tp = 4 if n_devices >= 16 and n_devices % 4 == 0 else \
            2 if n_devices >= 4 and n_devices % 2 == 0 else 1
        if kv_heads is not None:
            while tp > 1 and (tp > kv_heads or kv_heads % tp):
                tp //= 2
        sizes["tp"] = tp
        sizes["fsdp"] = n_devices // tp
    return sizes


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Logical-axis -> mesh-axis mapping. ``embed`` (d_model) maps to
    fsdp, a size-1 axis in serving; ``heads``/``ffn``/``vocab`` shard over
    tp (megatron splits); ``kv_heads`` (wk/wv and the cache's head axis) is
    separate from ``heads`` so the GQA guard can keep K/V whole while the
    Q-side stays sharded."""

    embed: Optional[str] = "fsdp"
    heads: Optional[str] = "tp"
    kv_heads: Optional[str] = "tp"
    ffn: Optional[str] = "tp"
    vocab: Optional[str] = "tp"
    batch: Tuple[str, ...] = ("dp", "fsdp")
    seq: Optional[str] = "sp"

    def spec(self, *logical: Optional[str]) -> Spec:
        return tuple(getattr(self, name) if name else None
                     for name in logical)


DEFAULT_RULES = MeshRules()

#: logical axes per parameter leaf name of the transformer LM; the order
#: matches the weight's shape
_PARAM_LOGICAL: Dict[str, Tuple[Optional[str], ...]] = {
    "tok_embed": ("vocab", "embed"),
    "pos_embed": (None, "embed"),
    "wq": ("embed", "heads"),
    "wk": ("embed", "kv_heads"),
    "wv": ("embed", "kv_heads"),
    "wo": ("heads", "embed"),
    "w_in": ("embed", "ffn"),
    "w_gate": ("embed", "ffn"),
    "w_out": ("ffn", "embed"),
    "w_lm_head": ("embed", "vocab"),
    "scale": ("embed",),
    "bias": ("embed",),
}


def serving_rules(config, tp: int) -> MeshRules:
    """Sharding rules for a serving engine at tensor-parallel degree
    ``tp``: every tp-sharded axis that ``tp`` does not divide is demoted to
    whole — above all the **GQA guard**: when tp does not divide
    ``kv_heads``, wk/wv and the KV cache stay whole on every rank and only
    the Q side (wq/wo, and ffn/vocab where they divide) is sharded."""
    def axis_or_none(size: int) -> Optional[str]:
        return "tp" if tp > 1 and size % tp == 0 else None

    return MeshRules(
        heads=axis_or_none(config.n_heads),
        kv_heads=axis_or_none(config.kv_heads),
        ffn=axis_or_none(config.d_ff),
        vocab=axis_or_none(config.vocab_size),
    )


def normalized_spec(*entries: Optional[str]) -> Spec:
    """A spec with its trailing ``None`` entries trimmed (JAX's
    normalized ``PartitionSpec`` spelling)."""
    trimmed = list(entries)
    while trimmed and trimmed[-1] is None:
        trimmed.pop()
    return tuple(trimmed)


def serving_cache_spec(rules: MeshRules) -> Spec:
    """JAX's spec of the serving KV cache ``[layers, slots | pages,
    positions, kv_heads, d_head]``: the pool axis over dp, the kv-head axis
    by the GQA-guarded rule. The port's engine keeps the pool whole on
    every rank (:func:`kernel_cache_spec`)."""
    return normalized_spec(None, "dp", None, rules.kv_heads, None)


def serving_scale_spec(rules: MeshRules) -> Spec:
    """JAX's spec of the int8 cache's scales ``[layers, pages,
    kv_heads]``: sharded exactly like the pages they describe."""
    return normalized_spec(None, "dp", rules.kv_heads)


def kernel_cache_spec(rules: MeshRules) -> Spec:
    """The cache layout of JAX's kernel route, the port's only one: page
    tables hold global page ids, so every rank holds the whole pool (no dp
    axis) and the kv-head axis is split over tp only where both head counts
    split (the kernel's ``h // group`` map stays aligned per shard)."""
    shard_heads = rules.heads == "tp" and rules.kv_heads == "tp"
    return normalized_spec(None, None, None, "tp" if shard_heads else None,
                           None)


def local_shape(shape: Tuple[int, ...], spec: Spec,
                axis_sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The shape of this rank's block of a tensor of ``shape`` laid out by
    ``spec``: each named axis divided by its mesh size."""
    out = list(shape)
    for index, axis in enumerate(spec):
        if axis is not None:
            size = axis_sizes.get(axis, 1)
            if out[index] % size:
                raise ValueError(f"axis {index} of {tuple(shape)} does not "
                                 f"split over {axis}={size}")
            out[index] //= size
    return tuple(out)


# -- the process mesh ---------------------------------------------------------

class ServingMesh:
    """One rank's view of a ``dp x tp`` serving mesh over the default
    process group: its coordinates, the process group of its tp replica,
    the backend and the device it computes on. Rank 0 is the controller
    (it owns every piece of host state and samples); the other ranks are
    workers (``serving/mesh_worker.py``). ``broken`` carries the reason
    once a dispatch failed part way: collectives may then be out of step
    between ranks, and the mesh refuses further use."""

    def __init__(self, dp: int, tp: int, rank: int, device: torch.device,
                 backend: str, tp_group: Any) -> None:
        self.dp = int(dp)
        self.tp = int(tp)
        self.rank = int(rank)
        self.device = device
        self.backend = backend
        #: process group of this rank's tp replica (None at tp 1)
        self.tp_group = tp_group
        self.broken: Optional[str] = None
        #: engines built on this mesh so far (the controller's BUILD
        #: commands): only the newest may dispatch
        self.builds = 0
        #: an idle controller sends a heartbeat this often, well inside the
        #: process group's timeout, so waiting workers never time out
        self.heartbeat_s = 10.0

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def is_controller(self) -> bool:
        return self.rank == 0

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def control_device(self) -> torch.device:
        """Where the controller's headers travel: host memory under gloo,
        the rank's card under NCCL (which moves only CUDA tensors)."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def _rank_device(device: DeviceLike) -> torch.device:
    """A rank's device: ``None`` means ``cuda:{LOCAL_RANK % device_count}``
    (and raises without CUDA); the CPU only when asked for by name."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


#: meshes already built in this process, per (process group, dp, tp,
#: device): building a mesh creates its tp process groups, a collective
#: call every rank must make in the same order, so a rebuilt engine reuses
#: its mesh instead of making new groups behind the workers' backs
_MESHES: Dict[Tuple[int, int, int, str], ServingMesh] = {}


def serving_mesh(dp: int = 1, tp: int = 1,
                 device: DeviceLike = None) -> ServingMesh:
    """This rank's ``dp x tp`` serving mesh over the initialised default
    process group. Raises when no process group is initialised or its size
    is not ``dp * tp`` — a serving config never silently falls back to
    fewer ranks than it was sized for (initialise the group with a bounded
    ``timeout``: a collective waiting on a dead peer then raises). ``device``
    None means
    ``cuda:{LOCAL_RANK % device_count}`` (and raises without CUDA); the CPU
    is used only when asked for by name, as the tests do. Every rank must
    call this in the same order: the first call for a shape creates the tp
    process groups."""
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh axes must be >= 1, got dp={dp} tp={tp}")
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"serving mesh dp={dp} x tp={tp} needs an initialised "
            f"torch.distributed process group of {dp * tp} ranks (rank 0 "
            "serves, the others run serving.mesh_worker.serve_worker); "
            "none is initialised")
    world = dist.get_world_size()
    if world != dp * tp:
        raise ValueError(
            f"serving mesh dp={dp} x tp={tp} needs {dp * tp} ranks, the "
            f"process group has {world}")
    resolved = _rank_device(device)
    key = (id(dist.group.WORLD), dp, tp, str(resolved))
    mesh = _MESHES.get(key)
    if mesh is not None:
        return mesh
    rank = dist.get_rank()
    tp_group = None
    if tp > 1:
        # one group per tp replica, made by every rank in the same order;
        # never the default group, so a controller header can never pair
        # with a tp collective left pending by a failed dispatch
        for replica in range(dp):
            group = dist.new_group(list(range(replica * tp,
                                              (replica + 1) * tp)))
            if replica == rank // tp:
                tp_group = group
    mesh = ServingMesh(dp, tp, rank, resolved, dist.get_backend(), tp_group)
    _MESHES[key] = mesh
    return mesh


# -- parameters ---------------------------------------------------------------

def map_named(fn, tree):
    """``fn(leaf, name)`` over a param tree, keeping its structure; a
    leaf's name is its last dict key (``"wq"``, ``"scale"``)."""
    def walk(node, name=None):
        if isinstance(node, dict):
            return {key: walk(value, key) for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(item, name) for item in node]
        return fn(node, name)

    return walk(tree)


def named_leaves(tree, name=None):
    """(name, leaf) pairs of a param tree, names as in ``map_named``, in
    the order of ``train.tree_leaves`` (dict keys sorted)."""
    if isinstance(tree, dict):
        return [pair for key in sorted(tree)
                for pair in named_leaves(tree[key], key)]
    if isinstance(tree, (list, tuple)):
        return [pair for item in tree for pair in named_leaves(item, name)]
    return [(name, tree)]


def shard_serving_params(params, rules: MeshRules, tp_rank: int, tp: int):
    """This rank's shard of a transformer param tree: each leaf named in
    ``_PARAM_LOGICAL`` keeps the contiguous ``tp_rank``-th of ``tp``
    blocks along every axis its rules map to tp — columns of
    ``wq``/``wk``/``wv``/``w_in``/``w_gate``/``w_lm_head``, rows of
    ``wo``/``w_out``/``tok_embed`` — and an axis the rules demote stays
    whole. Sliced leaves are copies, so the full tree can be freed."""
    def shard(leaf, name):
        logical = _PARAM_LOGICAL.get(name)
        if logical is None or len(logical) != leaf.dim() or tp == 1:
            return leaf
        out = leaf
        for axis, logical_axis in enumerate(logical):
            if logical_axis is None or getattr(rules, logical_axis) != "tp":
                continue
            size = leaf.shape[axis]
            if size % tp:
                raise ValueError(f"{name} axis {axis} ({size}) does not "
                                 f"split over tp={tp}")
            block = size // tp
            out = out.narrow(axis, tp_rank * block, block)
        return out if out is leaf else out.clone()

    return map_named(shard, params)


# -- collectives --------------------------------------------------------------

def tp_all_reduce(tensor: torch.Tensor, mesh: ServingMesh) -> torch.Tensor:
    """Sum of ``tensor`` over this rank's tp replica, in f32 (bf16 partial
    sums are added unrounded and rounded once), returned in the input's
    dtype; the identity at tp 1. Every rank of the replica gets the same
    bits."""
    if mesh.tp == 1:
        return tensor
    total = tensor.to(torch.float32, copy=True)
    dist.all_reduce(total, group=mesh.tp_group)
    return total.to(tensor.dtype)


def tp_assemble(local: torch.Tensor, dim: int,
                mesh: ServingMesh) -> torch.Tensor:
    """The whole of a tensor sharded in ``tp`` contiguous blocks along
    ``dim``, from this rank's block: each rank writes its block into a
    zero-filled buffer and one f32 sum over the replica fills it (adding
    zeros is exact). The identity at tp 1."""
    if mesh.tp == 1:
        return local
    dim = dim % local.dim()
    block = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = block * mesh.tp
    full = torch.zeros(shape, dtype=torch.float32, device=local.device)
    full.narrow(dim, mesh.tp_rank * block, block).copy_(local)
    dist.all_reduce(full, group=mesh.tp_group)
    return full.to(local.dtype)


class TensorParallel:
    """What a device body needs of a ``tp`` > 1 replica: the collectives
    GSPMD inserts in JAX, placed by the rules.

    * ``embed``: a vocab-sharded ``tok_embed`` is read by a masked local
      gather (rows outside this rank's block read as zeros) and summed.
    * ``reduce_attn``/``reduce_mlp``: the row-parallel partial sums of
      ``attn @ wo`` and ``gated @ w_out``, summed where heads/ffn split
      (None where they do not: the product is already whole).
    * ``logits``: the vocab-sharded LM head's columns, assembled.
    * ``all_heads``/``own_heads``: under the GQA guard (q heads split, K/V
      whole) the attention kernels run on every head, as JAX's
      ``shard_map`` with replicated specs does — q assembled over tp, the
      output cut back to this rank's heads — since the kernels' ``h //
      group`` map is only aligned per shard when both head counts split."""

    def __init__(self, mesh: ServingMesh, rules: MeshRules, config) -> None:
        self.mesh = mesh
        self.vocab_block = (config.vocab_size // mesh.tp
                            if rules.vocab == "tp" else None)
        self.reduce_attn = self._reduce if rules.heads == "tp" else None
        self.reduce_mlp = self._reduce if rules.ffn == "tp" else None
        #: the GQA guard's attention: on all heads, q assembled
        self.gather_heads = rules.heads == "tp" and rules.kv_heads is None

    def _reduce(self, partial: torch.Tensor) -> torch.Tensor:
        return tp_all_reduce(partial, self.mesh)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        if self.vocab_block is None:
            return table[tokens.long()]
        local = tokens.long() - self.mesh.tp_rank * self.vocab_block
        inside = (local >= 0) & (local < self.vocab_block)
        rows = table[torch.where(inside, local, 0)]
        rows = torch.where(inside[..., None], rows, 0)
        return tp_all_reduce(rows, self.mesh)

    def logits(self, local: torch.Tensor) -> torch.Tensor:
        if self.vocab_block is None:
            return local
        return tp_assemble(local, -1, self.mesh)

    def all_heads(self, q: torch.Tensor) -> torch.Tensor:
        return tp_assemble(q, 2, self.mesh)

    def own_heads(self, out: torch.Tensor) -> torch.Tensor:
        block = out.shape[2] // self.mesh.tp
        return out.narrow(2, self.mesh.tp_rank * block, block).contiguous()

    def attend(self, q: torch.Tensor, fn) -> torch.Tensor:
        """``fn(q)`` on this rank's heads, or on all heads under the
        guard (output cut back to this rank's heads)."""
        if not self.gather_heads:
            return fn(q)
        return self.own_heads(fn(self.all_heads(q)))


def shard_model(params, config, mesh: ServingMesh, sharded: bool = False
                ) -> Tuple[MeshRules, Any, Optional[TensorParallel]]:
    """What one rank holds of one model on a serving mesh: ``(rules,
    params, tp)`` — the GQA-guarded rules of ``config``, this rank's shard
    of ``params`` (taken as given when ``sharded``: leaves cut from a shard
    by the same rules, as a self-draft's are from its target's) and the
    model's :class:`TensorParallel` hooks (None at tp 1). A rank can hold
    several models this way (a serving target and its speculative draft),
    each by its own rules: a draft's GQA guard follows its own head
    counts."""
    rules = serving_rules(config, mesh.tp)
    if not sharded:
        params = shard_serving_params(params, rules, mesh.tp_rank, mesh.tp)
    tp = TensorParallel(mesh, rules, config) if mesh.tp > 1 else None
    return rules, params, tp


# -- the training mesh --------------------------------------------------------
#
# JAX trains under a 5-axis mesh ("pp", "dp", "fsdp", "tp", "sp"; its
# ``make_mesh``) with params and Adam moments laid out by ``tree_shardings``
# under ``DEFAULT_RULES``. The port runs one process per rank: rank ``r`` is
# JAX's device ``r``, at the position of ``r`` unravelled over the shape
# ``(pp, dp, fsdp, tp, sp)`` (sp innermost: ``sp_rank = r % sp``, ``tp_rank =
# (r // sp) % tp``, and so on outwards), and holds the contiguous block of
# every leaf that JAX's sharding puts on that device. Params are replicated
# over sp (each sp rank holds a block of the sequence's activations) and
# cut over pp by layer: a pp rank holds only its stage's layers
# (``stage_layers``), the embedding, final norm and LM head whole.

#: the axes of JAX's ``make_mesh``, outermost first
AXES = ("pp", "dp", "fsdp", "tp", "sp")
#: the axes every ``TrainMesh.coords`` names, whatever their size
_BASE_AXES = ("dp", "fsdp", "tp")


def mesh_sizes(n_devices: int, **sizes: int) -> Dict[str, int]:
    """JAX's ``make_mesh`` rule for the axis sizes of ``n_devices``: at
    most one axis may be -1 and takes what the others leave; the product
    must equal ``n_devices``."""
    sizes = {axis: int(sizes.get(axis, 1)) for axis in AXES}
    unknown = [axis for axis, size in sizes.items() if size == -1]
    known = math.prod(size for size in sizes.values() if size != -1)
    if len(unknown) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if any(size < 1 and size != -1 for size in sizes.values()):
        raise ValueError(f"mesh axes must be >= 1 or -1, got {sizes}")
    if unknown:
        if n_devices % known:
            raise ValueError(f"cannot infer {unknown[0]}: {n_devices} ranks "
                             f"not divisible by {known}")
        sizes[unknown[0]] = n_devices // known
    if math.prod(sizes.values()) != n_devices:
        raise ValueError(f"mesh {sizes} needs {math.prod(sizes.values())} "
                         f"ranks, the process group has {n_devices}")
    return sizes


def is_staged(path: str) -> bool:
    """Whether a leaf at ``path`` (``"blocks/3/wq"``, or a bare name) is
    a layer's: cut over pp by stage, not replicated over it."""
    return path.startswith("blocks/")


class TrainMesh:
    """One rank's view of a ``pp x dp x fsdp x tp x sp`` training mesh: its
    coordinates, the device it computes on and its process groups, each
    None where it would hold one rank:

    * ``tp_group``: the ranks that differ from it in tp alone (the
      megatron products' sums);
    * ``fsdp_group``: those that differ in fsdp alone (the ZeRO-3 gathers
      of the ``embed`` axis);
    * ``sp_group``: those that differ in sp alone, in sp order (the ring);
    * ``pp_group``: those that differ in pp alone, in stage order (the
      pipeline's hand-offs);
    * ``data_group``: every rank at its tp and pp coordinates, dp x fsdp x
      sp of them (the gradient sums of the leaves they share, and the
      loss).

    A mesh built without groups (``train_mesh`` builds them) serves only
    the checks of its sizes and layout."""

    def __init__(self, dp: int, fsdp: int, tp: int, rank: int = 0,
                 device: torch.device = torch.device("cpu"),
                 tp_group: Any = None, fsdp_group: Any = None,
                 data_group: Any = None, *, sp: int = 1, pp: int = 1,
                 sp_group: Any = None, pp_group: Any = None) -> None:
        self.dp, self.fsdp, self.tp = int(dp), int(fsdp), int(tp)
        self.sp, self.pp = int(sp), int(pp)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.tp_group = tp_group
        self.fsdp_group = fsdp_group
        self.data_group = data_group
        self.sp_group = sp_group
        self.pp_group = pp_group

    @property
    def world(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp * self.pp

    @property
    def axis_sizes(self) -> Dict[str, int]:
        """Every axis of JAX's mesh with its size (JAX's ``mesh.shape``)."""
        return {"pp": self.pp, "dp": self.dp, "fsdp": self.fsdp,
                "tp": self.tp, "sp": self.sp}

    def position_of(self, rank: int) -> Dict[str, int]:
        """The coordinates of ``rank`` on all five axes: ``rank``
        unravelled over ``(pp, dp, fsdp, tp, sp)``, sp innermost."""
        sizes, position = self.axis_sizes, {}
        for axis in reversed(AXES):
            position[axis] = rank % sizes[axis]
            rank //= sizes[axis]
        return {axis: position[axis] for axis in AXES}

    def rank_at(self, position: Dict[str, int]) -> int:
        """The rank at ``position`` (every axis named), raveled."""
        rank = 0
        for axis in AXES:
            rank = rank * self.axis_sizes[axis] + position[axis]
        return rank

    @property
    def position(self) -> Dict[str, int]:
        return self.position_of(self.rank)

    @property
    def coords(self) -> Dict[str, int]:
        """The rank's coordinate on dp, fsdp and tp, and on sp and pp where
        the mesh cuts them (an axis of size 1 is coordinate 0)."""
        sizes = self.axis_sizes
        return {axis: index for axis, index in self.position.items()
                if axis in _BASE_AXES or sizes[axis] > 1}

    def axis_ranks(self, axis: str) -> list:
        """The ranks that differ from this one along ``axis`` alone, in
        that axis's order."""
        position = self.position
        return [self.rank_at({**position, axis: index})
                for index in range(self.axis_sizes[axis])]

    @property
    def tp_rank(self) -> int:
        return self.position["tp"]

    @property
    def sp_rank(self) -> int:
        return self.position["sp"]

    @property
    def pp_rank(self) -> int:
        return self.position["pp"]

    @property
    def data_rank(self) -> int:
        """The rank's block of the global batch, ``dp_rank * fsdp +
        fsdp_rank``: every sp, tp and pp rank of a data shard holds the
        same rows (JAX's ``batch_sharding``)."""
        position = self.position
        return position["dp"] * self.fsdp + position["fsdp"]

    @property
    def data_size(self) -> int:
        return self.dp * self.fsdp

    def stage_layers(self, n_layers: int) -> range:
        """The global indices of the layers this rank's pp stage holds."""
        if n_layers % self.pp:
            raise ValueError(f"{n_layers} layers not divisible by "
                             f"pp={self.pp}")
        per_stage = n_layers // self.pp
        return range(self.pp_rank * per_stage,
                     (self.pp_rank + 1) * per_stage)

    def owns(self, spec: Spec, staged: bool = False) -> bool:
        """Whether this rank holds the copy of its block of a leaf laid out
        by ``spec`` that counts: its coordinate is 0 on every axis the
        leaf is replicated over (pp is not one for a layer's leaf,
        ``staged``: each stage holds its own layers). Each block of a leaf
        has exactly one owner, so a sum over owners counts every element
        once (the global gradient norm) and the owners' files hold a leaf
        once (the checkpoint)."""
        named = set(spec)
        if staged:
            named.add("pp")
        return all(index == 0 for axis, index in self.position.items()
                   if axis not in named)


#: training meshes already built in this process, per (process group,
#: sizes, device): building one creates process groups, which every rank
#: must do in the same order
_TRAIN_MESHES: Dict[Tuple[Any, ...], TrainMesh] = {}


def train_mesh(dp: int = 1, fsdp: int = -1, tp: int = 1, sp: int = 1,
               pp: int = 1, device: DeviceLike = None) -> TrainMesh:
    """This rank's ``pp x dp x fsdp x tp x sp`` training mesh over the
    initialised default process group, by JAX's ``make_mesh`` rule (one
    axis may be -1; the product must equal the group's size — never fewer
    ranks than asked for). ``device`` None means ``cuda:{LOCAL_RANK %
    device_count}`` (and raises without CUDA); the CPU is used only when
    asked for by name. Every rank must call this in the same order: the
    first call for a shape creates its process groups."""
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"training mesh dp={dp} x fsdp={fsdp} x tp={tp} x sp={sp} x "
            f"pp={pp} needs an initialised torch.distributed process group "
            "(one process per rank); none is initialised")
    world = dist.get_world_size()
    sizes = mesh_sizes(world, dp=dp, fsdp=fsdp, tp=tp, sp=sp, pp=pp)
    resolved = _rank_device(device)
    key = (id(dist.group.WORLD), *(sizes[axis] for axis in AXES),
           str(resolved))
    mesh = _TRAIN_MESHES.get(key)
    if mesh is not None:
        return mesh
    rank = dist.get_rank()
    layout = TrainMesh(sizes["dp"], sizes["fsdp"], sizes["tp"],
                       sp=sizes["sp"], pp=sizes["pp"])

    def own_group(member_lists):
        """Create every group (all ranks, one order); return this rank's.
        Groups of one rank are not made: their collectives are skipped."""
        mine = None
        for members in member_lists:
            if len(members) == 1:
                continue
            group = dist.new_group(members)
            if rank in members:
                mine = group
        return mine

    def lines(axis):
        """Every group of ranks that differ along ``axis`` alone, each
        listed once (from its member at coordinate 0), in rank order."""
        return [TrainMesh(sizes["dp"], sizes["fsdp"], sizes["tp"], first,
                          sp=sizes["sp"], pp=sizes["pp"]).axis_ranks(axis)
                for first in range(world)
                if layout.position_of(first)[axis] == 0]

    def data_lines():
        """The ranks at each (pp, tp) coordinate: dp x fsdp x sp each."""
        groups: Dict[Tuple[int, int], list] = {}
        for member in range(world):
            position = layout.position_of(member)
            groups.setdefault((position["pp"], position["tp"]),
                              []).append(member)
        return [groups[key] for key in sorted(groups)]

    tp_group = own_group(lines("tp"))
    fsdp_group = own_group(lines("fsdp"))
    data_group = own_group(data_lines())
    sp_group = own_group(lines("sp"))
    pp_group = own_group(lines("pp"))
    mesh = TrainMesh(sizes["dp"], sizes["fsdp"], sizes["tp"], rank, resolved,
                     tp_group, fsdp_group, data_group, sp=sizes["sp"],
                     pp=sizes["pp"], sp_group=sp_group, pp_group=pp_group)
    _TRAIN_MESHES[key] = mesh
    return mesh


def train_spec(name: str, ndim: int,
               rules: MeshRules = DEFAULT_RULES) -> Spec:
    """The mesh axes of a training leaf named ``name`` (its last key) with
    ``ndim`` axes, by ``_PARAM_LOGICAL`` and ``rules`` (JAX's
    ``param_sharding``): ``embed`` over fsdp, ``heads``/``kv_heads``/
    ``ffn``/``vocab`` over tp, so ``wq`` ``("embed", "heads")`` is cut on
    both. An unknown leaf is whole on every rank."""
    logical = _PARAM_LOGICAL.get(name)
    if logical is None or len(logical) != ndim:
        return (None,) * ndim
    return rules.spec(*logical)


def whole_shape(local: Tuple[int, ...], spec: Spec,
                mesh: TrainMesh) -> Tuple[int, ...]:
    """The whole shape of a leaf laid out by ``spec`` whose block on a rank
    of ``mesh`` has shape ``local``."""
    return tuple(size * (mesh.axis_sizes[axis] if axis else 1)
                 for size, axis in zip(local, spec))


def block_starts(shape: Tuple[int, ...], spec: Spec,
                 mesh: TrainMesh) -> Tuple[int, ...]:
    """Where this rank's block of a leaf of global ``shape`` starts, per
    axis."""
    coords = mesh.coords
    local = local_shape(shape, spec, mesh.axis_sizes)
    return tuple(0 if axis is None else coords[axis] * size
                 for axis, size in zip(spec, local))


def shard_train_leaf(leaf: torch.Tensor, name: str, mesh: TrainMesh,
                     rules: MeshRules = DEFAULT_RULES) -> torch.Tensor:
    """This rank's contiguous block of a whole training leaf (a copy, so
    the whole leaf can be freed); an axis that does not split raises,
    naming the leaf and the mesh axis."""
    spec = train_spec(name, leaf.dim(), rules)
    out = leaf
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        size = mesh.axis_sizes[axis]
        if leaf.shape[dim] % size:
            raise ValueError(f"{name} axis {dim} ({leaf.shape[dim]}) does "
                             f"not split over {axis}={size}")
        block = leaf.shape[dim] // size
        out = out.narrow(dim, mesh.coords[axis] * block, block)
    return out if out is leaf else out.clone(
        memory_format=torch.contiguous_format)


def shard_train_params(params, rules: MeshRules, mesh: TrainMesh):
    """This rank's shard of a whole transformer param tree (or Adam
    moment tree) by ``rules`` — the generalisation of
    ``shard_serving_params`` to the fsdp axis: every leaf keeps the block
    at this rank's coordinates along each axis its rules map to fsdp or
    tp. JAX's ``tree_shardings`` shard for the device at the same
    coordinates, byte for byte."""
    return map_named(lambda leaf, name: shard_train_leaf(leaf, name, mesh,
                                                         rules), params)


def check_train_mesh(config, mesh: TrainMesh, batch_size: Optional[int] = None,
                     accum: int = 1, seq_len: Optional[int] = None) -> None:
    """Refuse a mesh whose axes do not divide what they split: tp the
    query and K/V heads (a head is never cut), d_ff and the vocab; fsdp
    d_model; pp the layers; sp the sequence length; dp x fsdp x ``accum``
    the batch (each rank's rows split into equal microbatches), and the
    pipeline's microbatch count each of those. JAX lets GSPMD reshard
    there instead (ROADMAP C). Training has no GQA guard: K/V heads stay
    on tp, as JAX's ``DEFAULT_RULES`` keep them."""
    def divides(size: int, what: str, axis: str, count: int) -> None:
        if count % size:
            raise ValueError(f"{axis}={size} does not divide {what} "
                             f"({count})")

    divides(mesh.tp, "n_heads (wq/wo heads axis)", "tp", config.n_heads)
    divides(mesh.tp, "kv_heads (wk/wv kv_heads axis)", "tp", config.kv_heads)
    divides(mesh.tp, "d_ff (w_in/w_gate/w_out ffn axis)", "tp", config.d_ff)
    divides(mesh.tp, "vocab_size (tok_embed/w_lm_head vocab axis)", "tp",
            config.vocab_size)
    divides(mesh.fsdp, "d_model (the embed axis of every leaf)", "fsdp",
            config.d_model)
    mesh.stage_layers(config.n_layers)          # "not divisible by pp"
    if seq_len is not None:
        divides(mesh.sp, "the sequence length", "sp", seq_len)
    if batch_size is not None:
        divides(mesh.data_size * accum,
                f"batch_size: {accum} microbatch(es) on each of "
                f"{mesh.data_size} data ranks (dp x fsdp)",
                "dp x fsdp x grad_accum_steps", batch_size)
        if mesh.pp > 1:
            from .pipeline import pipeline_microbatches

            pipeline_microbatches(batch_size // (mesh.data_size * accum),
                                  mesh, config.pp_microbatches)


def share_bytes(whole, mesh: TrainMesh,
                rules: MeshRules = DEFAULT_RULES) -> int:
    """The bytes of a whole tree (``meta`` leaves will do) that the specs
    give one rank of ``mesh``: each leaf's bytes over the sizes of the
    axes its spec names, and a pp stage's share of the layers."""
    sizes = mesh.axis_sizes

    def share(tree) -> int:
        return sum(leaf.numel() * leaf.element_size() // math.prod(
            sizes[axis] for axis in train_spec(name, leaf.dim(), rules)
            if axis) for name, leaf in named_leaves(tree))

    rest = {key: value for key, value in whole.items() if key != "blocks"}
    return share(rest) + share(whole.get("blocks", [])) // mesh.pp
