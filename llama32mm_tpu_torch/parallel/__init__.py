"""Tensor- and data-parallel serving and training across GPUs
(counterpart of ``llama32mm_tpu/parallel/``): process meshes over
``torch.distributed`` and the differentiable collectives (``mesh.py``), the
Megatron-style TP layout, the data, sequence and ZeRO-1 placements
(``sharding.py``), and GPipe pipeline parallelism (``pipeline.py``)."""

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
    ppermute,
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
    seq_data_sharding,
    set_placement,
    shard_params,
    tp_of,
    zero1_shardings,
)


# pipeline.py imports the models, which import parallel.mesh: its names load
# on first use
_PIPELINE = ("PipelineStage", "PipelineTrainState", "make_pipeline_lora_train_step",
             "make_pipeline_train_step", "pipeline_causal_lm_loss", "pipeline_decoder_hidden",
             "pipeline_param_specs", "pipeline_shard_lora", "pipeline_shard_params")


def __getattr__(name):
    if name in _PIPELINE:
        from llama32mm_tpu_torch.parallel import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "AXES", "AXIS_DP", "AXIS_PP", "AXIS_SP", "AXIS_TP", "Mesh", "Placement", "TPShard",
    "all_gather", "copy_to_tp", "create_mesh", "data_sharding", "gather_from_tp",
    "init_distributed", "kv_cache_sharding", "lora_shardings", "mesh_of", "param_shardings",
    "placement_of", "ppermute", "reduce_from_tp", "reduce_scatter", "seq_data_sharding",
    "set_placement", "shard_params", "single_device_mesh", "tp_of", "zero1_shardings",
    *_PIPELINE,
]
