"""Parallelism layer of the port: the serving mesh over
``torch.distributed`` (``mesh.py``), the counterpart of the serving half of
``tensorhive_tpu/parallel/``. Ring attention, the pipeline and sharded
training are not ported yet."""
from .mesh import (
    DEFAULT_RULES,
    MeshRules,
    ServingMesh,
    TensorParallel,
    best_mesh_shape,
    serving_mesh,
    serving_rules,
    shard_serving_params,
    tp_all_reduce,
    tp_assemble,
)

__all__ = [
    "DEFAULT_RULES",
    "MeshRules",
    "ServingMesh",
    "TensorParallel",
    "best_mesh_shape",
    "serving_mesh",
    "serving_rules",
    "shard_serving_params",
    "tp_all_reduce",
    "tp_assemble",
]
