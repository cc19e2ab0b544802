"""The fused ops, each a hand-written CUDA kernel beside its plain PyTorch
version (``csrc/``, ``ops/cuda/``); ``impl`` picks one (``dispatch.py``)."""

from llama32mm_tpu_torch.ops.attention import gqa_attention
from llama32mm_tpu_torch.ops.dispatch import default_impl, resolve_impl
from llama32mm_tpu_torch.ops.rmsnorm import fused_add_rmsnorm
from llama32mm_tpu_torch.ops.rope import apply_rotary_pos_emb, rope_cos_sin, rotate_half
from llama32mm_tpu_torch.ops.swiglu import fused_swiglu, swiglu_down

__all__ = [
    "default_impl",
    "resolve_impl",
    "fused_add_rmsnorm",
    "fused_swiglu",
    "swiglu_down",
    "rope_cos_sin",
    "apply_rotary_pos_emb",
    "rotate_half",
    "gqa_attention",
]
