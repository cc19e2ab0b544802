"""The KV cache, the samplers and the profiling helpers."""

from llama32mm_tpu_torch.utils.kvcache import (
    KVCache,
    init_kv_cache,
    update_layer_cache,
    update_stacked,
)
from llama32mm_tpu_torch.utils.profiling import Timer, annotate, trace
from llama32mm_tpu_torch.utils.sampling import filter_logits, select_next_token

__all__ = [
    "KVCache",
    "init_kv_cache",
    "update_layer_cache",
    "update_stacked",
    "Timer",
    "annotate",
    "trace",
    "filter_logits",
    "select_next_token",
]
