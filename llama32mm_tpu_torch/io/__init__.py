from llama32mm_tpu_torch.io.checkpoint import (
    build_config_from_hf,
    load_checkpoint_params,
    load_hf_model,
    save_checkpoint_params,
    translate_hf_key,
)
from llama32mm_tpu_torch.io.distributed import (
    ShardedCheckpointer,
    TrainCheckpointManager,
    abstract_state,
)

__all__ = [
    "ShardedCheckpointer",
    "TrainCheckpointManager",
    "abstract_state",
    "build_config_from_hf",
    "load_checkpoint_params",
    "load_hf_model",
    "save_checkpoint_params",
    "translate_hf_key",
]
