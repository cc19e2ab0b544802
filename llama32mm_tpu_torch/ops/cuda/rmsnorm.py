"""Fused add-RMSNorm forward: the CUDA kernel (``csrc/rmsnorm.cu``) and its
plain PyTorch version.

Both compute ``t = x + residual`` in fp32, ``t * rsqrt(mean(t^2) + eps) * w``
and one rounding to x's dtype, as the Pallas kernel
``llama32mm_tpu/ops/pallas/rmsnorm.py::_fwd_only_kernel`` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from llama32mm_tpu_torch.ops.cuda.build import check, load_library
from llama32mm_tpu_torch.ops.cuda.common import counted, dtype_code, require, stream_of


@counted("launches")
def fused_add_rmsnorm_cuda(
    x: torch.Tensor, weight: torch.Tensor, eps: float, residual: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``rmsnorm(x + residual) * weight`` on the card. x, residual ``[..., C]``,
    weight ``[C]``; a missing residual is read as zeros without a tensor."""
    require("x", x, x)
    c = x.shape[-1]
    require("weight", weight, x, (c,))
    if residual is not None:
        require("residual", residual, x, x.shape)
    out = torch.empty_like(x)
    rows = x.numel() // c if c else 0
    status = load_library().l32_rmsnorm_fwd(
        x.data_ptr(), None if residual is None else residual.data_ptr(), weight.data_ptr(),
        out.data_ptr(), rows, c, float(eps), dtype_code(x), stream_of(x),
    )
    check(status, "rmsnorm kernel")
    fused_add_rmsnorm_cuda.launches += 1
    return out


@counted("calls")
def fused_add_rmsnorm_plain(
    x: torch.Tensor, weight: torch.Tensor, eps: float, residual: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The kernel's math in PyTorch: fp32 add and sum of squares."""
    fused_add_rmsnorm_plain.calls += 1
    t = x.float()
    if residual is not None:
        t = t + residual.float()
    inv = torch.rsqrt(t.square().mean(dim=-1, keepdim=True) + eps)
    return (t * inv * weight.float()).to(x.dtype)
