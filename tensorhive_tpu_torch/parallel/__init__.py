"""Parallelism layer of the port, the counterpart of
``tensorhive_tpu/parallel/`` over ``torch.distributed``: the serving mesh
and the ``dp x fsdp x tp`` training mesh (``mesh.py``) and the training
collectives (``train_parallel.py``). Ring attention (sp) and the pipeline
(pp) are not ported yet."""
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

__all__ = [
    "DEFAULT_RULES",
    "MeshRules",
    "ServingMesh",
    "TensorParallel",
    "TrainMesh",
    "best_mesh_shape",
    "serving_mesh",
    "serving_rules",
    "shard_serving_params",
    "shard_train_params",
    "tp_all_reduce",
    "tp_assemble",
    "train_mesh",
]
