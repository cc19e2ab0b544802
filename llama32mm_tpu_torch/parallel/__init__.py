"""Tensor- and data-parallel serving and training across GPUs
(counterpart of ``llama32mm_tpu/parallel/``): process meshes over
``torch.distributed`` and the differentiable collectives (``mesh.py``), the
Megatron-style TP layout, the data and ZeRO-1 placements (``sharding.py``).
Sequence and pipeline parallelism are not ported yet (ROADMAP.md, queue 1)."""

from llama32mm_tpu_torch.parallel.mesh import (
    AXES,
    AXIS_DP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    Mesh,
    all_gather,
    copy_to_tp,
    create_mesh,
    gather_from_tp,
    init_distributed,
    reduce_from_tp,
    reduce_scatter,
    single_device_mesh,
)
from llama32mm_tpu_torch.parallel.sharding import (
    Placement,
    TPShard,
    data_sharding,
    kv_cache_sharding,
    lora_shardings,
    mesh_of,
    param_shardings,
    placement_of,
    set_placement,
    shard_params,
    tp_of,
    zero1_shardings,
)

__all__ = [
    "AXES", "AXIS_DP", "AXIS_PP", "AXIS_SP", "AXIS_TP", "Mesh", "Placement", "TPShard",
    "all_gather", "copy_to_tp", "create_mesh", "data_sharding", "gather_from_tp",
    "init_distributed", "kv_cache_sharding", "lora_shardings", "mesh_of", "param_shardings",
    "placement_of", "reduce_from_tp", "reduce_scatter", "set_placement", "shard_params",
    "single_device_mesh", "tp_of", "zero1_shardings",
]
