"""Parallelism layer of the port, the counterpart of
``tensorhive_tpu/parallel/`` over ``torch.distributed``: the serving mesh
and the ``pp x dp x fsdp x tp x sp`` training mesh (``mesh.py``), the
training collectives (``train_parallel.py``), ring attention over sp
(``ring.py``) and the GPipe pipeline over pp (``pipeline.py``)."""
from .mesh import (
    DEFAULT_RULES,
    MeshRules,
    ServingMesh,
    TensorParallel,
    TrainMesh,
    best_mesh_shape,
    serving_mesh,
    serving_rules,
    shard_serving_params,
    shard_train_params,
    tp_all_reduce,
    tp_assemble,
    train_mesh,
)
from .pipeline import pipeline_apply, pipeline_microbatches, pp_enabled
from .ring import ring_attention

__all__ = [
    "DEFAULT_RULES",
    "MeshRules",
    "ServingMesh",
    "TensorParallel",
    "TrainMesh",
    "best_mesh_shape",
    "pipeline_apply",
    "pipeline_microbatches",
    "pp_enabled",
    "ring_attention",
    "serving_mesh",
    "serving_rules",
    "shard_serving_params",
    "shard_train_params",
    "tp_all_reduce",
    "tp_assemble",
    "train_mesh",
]
