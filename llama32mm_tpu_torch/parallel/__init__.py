"""Tensor-parallel serving across GPUs (counterpart of
``llama32mm_tpu/parallel/``): process meshes over ``torch.distributed``
(``mesh.py``) and the Megatron-style TP layout (``sharding.py``). Sequence
and pipeline parallelism are not ported yet (ROADMAP.md, queue 1)."""

from llama32mm_tpu_torch.parallel.mesh import (
    AXES,
    AXIS_DP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    Mesh,
    create_mesh,
    init_distributed,
    single_device_mesh,
)
from llama32mm_tpu_torch.parallel.sharding import (
    Placement,
    TPShard,
    kv_cache_sharding,
    param_shardings,
    shard_params,
    tp_of,
)

__all__ = [
    "AXES", "AXIS_DP", "AXIS_PP", "AXIS_SP", "AXIS_TP", "Mesh", "Placement", "TPShard",
    "create_mesh", "init_distributed", "kv_cache_sharding", "param_shardings", "shard_params",
    "single_device_mesh", "tp_of",
]
