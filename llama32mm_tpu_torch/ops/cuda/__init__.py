"""The port's hand-written Hopper kernels and their plain PyTorch versions.

Importing this package builds nothing: the kernel library is compiled and
loaded at the first launch (``build.load_library``).
"""

from llama32mm_tpu_torch.ops.cuda.attention import (
    flash_attention_bwd_dkv_cuda,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq_cuda,
    flash_attention_bwd_dq_plain,
    flash_attention_cuda,
    flash_attention_fwd_lse_cuda,
    flash_attention_fwd_lse_plain,
    flash_attention_int8kv_cuda,
    flash_attention_int8kv_plain,
    flash_attention_plain,
    flash_attention_tc_cuda,
    flash_attention_tc_int8kv_cuda,
    flash_attention_tc_int8kv_plain,
    flash_attention_tc_lse_cuda,
    flash_attention_tc_lse_plain,
    flash_attention_tc_plain,
)
from llama32mm_tpu_torch.ops.cuda.flash_decode import (
    flash_decode_cuda,
    flash_decode_int8kv_cuda,
    flash_decode_int8kv_plain,
    flash_decode_plain,
)
from llama32mm_tpu_torch.ops.cuda.gemv import gemv_cuda, gemv_plain
from llama32mm_tpu_torch.ops.cuda.qgemv import (
    gemv_int4_cuda,
    gemv_int4_plain,
    gemv_int4_w4a8_cuda,
    gemv_int4_w4a8_plain,
    gemv_int8_cuda,
    gemv_int8_plain,
)
from llama32mm_tpu_torch.ops.cuda.qmatmul import qmatmul_cuda, qmatmul_plain
from llama32mm_tpu_torch.ops.cuda.rmsnorm import (
    fused_add_rmsnorm_cuda,
    fused_add_rmsnorm_plain,
    rmsnorm_bwd_cuda,
    rmsnorm_bwd_plain,
    rmsnorm_fwd_train_cuda,
    rmsnorm_fwd_train_plain,
)
from llama32mm_tpu_torch.ops.cuda.swiglu import (
    fused_swiglu_bwd_cuda,
    fused_swiglu_bwd_plain,
    fused_swiglu_cuda,
    fused_swiglu_plain,
    swiglu_down_cuda,
    swiglu_down_plain,
)

# kernel name -> (wrapper, plain version)
KERNELS = {
    "rmsnorm": (fused_add_rmsnorm_cuda, fused_add_rmsnorm_plain),
    "gemv": (gemv_cuda, gemv_plain),
    "swiglu": (fused_swiglu_cuda, fused_swiglu_plain),
    "flash_attention": (flash_attention_cuda, flash_attention_plain),
    "gemv_int8": (gemv_int8_cuda, gemv_int8_plain),
    "gemv_int4": (gemv_int4_cuda, gemv_int4_plain),
    "qmatmul": (qmatmul_cuda, qmatmul_plain),
    "flash_attention_int8kv": (flash_attention_int8kv_cuda, flash_attention_int8kv_plain),
    "rmsnorm_fwd_train": (rmsnorm_fwd_train_cuda, rmsnorm_fwd_train_plain),
    "rmsnorm_bwd": (rmsnorm_bwd_cuda, rmsnorm_bwd_plain),
    "swiglu_bwd": (fused_swiglu_bwd_cuda, fused_swiglu_bwd_plain),
    "flash_attention_lse": (flash_attention_fwd_lse_cuda, flash_attention_fwd_lse_plain),
    "flash_attention_bwd_dq": (flash_attention_bwd_dq_cuda, flash_attention_bwd_dq_plain),
    "flash_attention_bwd_dkv": (flash_attention_bwd_dkv_cuda, flash_attention_bwd_dkv_plain),
    "gemv_int4_w4a8": (gemv_int4_w4a8_cuda, gemv_int4_w4a8_plain),
    "swiglu_down": (swiglu_down_cuda, swiglu_down_plain),
    "flash_attention_tc": (flash_attention_tc_cuda, flash_attention_tc_plain),
    "flash_attention_tc_int8kv": (flash_attention_tc_int8kv_cuda, flash_attention_tc_int8kv_plain),
    "flash_attention_tc_lse": (flash_attention_tc_lse_cuda, flash_attention_tc_lse_plain),
    "flash_decode": (flash_decode_cuda, flash_decode_plain),
    "flash_decode_int8kv": (flash_decode_int8kv_cuda, flash_decode_int8kv_plain),
}


def reset_counters() -> None:
    for wrapper, plain in KERNELS.values():
        wrapper.launches = 0
        plain.calls = 0


def launch_counts() -> dict:
    return {name: wrapper.launches for name, (wrapper, _) in KERNELS.items()}


def plain_counts() -> dict:
    return {name: plain.calls for name, (_, plain) in KERNELS.items()}
