"""Fused add-RMSNorm: the CUDA kernels (``csrc/rmsnorm.cu``) and their plain
PyTorch versions.

- inference forward: ``t = x + residual`` in fp32,
  ``t * rsqrt(mean(t^2) + eps) * w`` and one rounding to x's dtype, as the
  Pallas kernel ``llama32mm_tpu/ops/pallas/rmsnorm.py::_fwd_only_kernel``;
- training forward (``::_fwd_kernel``): ``rms = sqrt(mean(t^2) + eps)``,
  ``out = t * (1 / rms) * w``, and for the backward ``t`` in x's dtype and
  the fp32 ``rms`` of each row;
- backward (``::_bwd_kernel``): ``dt = (g*w - t*sum(g*w*t)/(C*rms^2))/rms``
  in t's dtype and, unless the weight is frozen, ``dw = sum_rows g*t/rms``
  in fp32, cast to the weight's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from llama32mm_tpu_torch.ops.cuda.build import check, load_library
from llama32mm_tpu_torch.ops.cuda.common import acc_dtype, counted, dtype_code, require, stream_of

# Blocks of the backward kernel (two on each of the H100's 132 SMs): each
# walks every BWD_PARTS-th row and sums dw over its rows into one row of a
# [BWD_PARTS, C] fp32 workspace, reduced in a fixed order by a second kernel.
BWD_PARTS = 264


def _launch_fwd(x, weight, eps, residual, train: bool):
    require("x", x, x)
    c = x.shape[-1]
    require("weight", weight, x, (c,))
    if residual is not None:
        require("residual", residual, x, x.shape)
    out = torch.empty_like(x)
    t = torch.empty_like(x) if train else None
    rms = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device) if train else None
    rows = x.numel() // c if c else 0
    status = load_library().l32_rmsnorm_fwd(
        x.data_ptr(), None if residual is None else residual.data_ptr(), weight.data_ptr(),
        out.data_ptr(), None if t is None else t.data_ptr(),
        None if rms is None else rms.data_ptr(), rows, c, float(eps), dtype_code(x), stream_of(x),
    )
    check(status, "rmsnorm kernel")
    return out, t, rms


@counted("launches")
def fused_add_rmsnorm_cuda(
    x: torch.Tensor, weight: torch.Tensor, eps: float, residual: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``rmsnorm(x + residual) * weight`` on the card. x, residual ``[..., C]``,
    weight ``[C]``; a missing residual is read as zeros without a tensor."""
    out, _, _ = _launch_fwd(x, weight, eps, residual, train=False)
    fused_add_rmsnorm_cuda.launches += 1
    return out


@counted("calls")
def fused_add_rmsnorm_plain(
    x: torch.Tensor, weight: torch.Tensor, eps: float, residual: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The kernel's math in PyTorch: fp32 add and sum of squares."""
    fused_add_rmsnorm_plain.calls += 1
    t = x.to(acc_dtype(x))
    if residual is not None:
        t = t + residual.to(t.dtype)
    inv = torch.rsqrt(t.square().mean(dim=-1, keepdim=True) + eps)
    return (t * inv * weight.to(t.dtype)).to(x.dtype)


@counted("launches")
def rmsnorm_fwd_train_cuda(x: torch.Tensor, weight: torch.Tensor, eps: float,
                           residual: Optional[torch.Tensor] = None):
    """The training forward on the card: ``(out, t, rms)``, ``rms`` fp32
    ``x.shape[:-1]``."""
    res = _launch_fwd(x, weight, eps, residual, train=True)
    rmsnorm_fwd_train_cuda.launches += 1
    return res


@counted("calls")
def rmsnorm_fwd_train_plain(x: torch.Tensor, weight: torch.Tensor, eps: float,
                            residual: Optional[torch.Tensor] = None):
    """The training forward in PyTorch: ``(out, t, rms)``."""
    rmsnorm_fwd_train_plain.calls += 1
    t = x.to(acc_dtype(x))
    if residual is not None:
        t = t + residual.to(t.dtype)
    rms = torch.sqrt(t.square().mean(dim=-1, keepdim=True) + eps)
    out = (t * (1.0 / rms) * weight.to(t.dtype)).to(x.dtype)
    return out, t.to(x.dtype), rms[..., 0]


@counted("launches")
def rmsnorm_bwd_cuda(g: torch.Tensor, t: torch.Tensor, weight: torch.Tensor, rms: torch.Tensor,
                     need_dw: bool = True):
    """The backward on the card: ``(dt, dw)``, ``dw`` None when not needed."""
    require("t", t, t)
    c = t.shape[-1]
    require("g", g, t, t.shape)
    require("weight", weight, t, (c,))
    require("rms", rms, t, t.shape[:-1], torch.float32)
    rows = t.numel() // c if c else 0
    parts = max(1, min(rows, BWD_PARTS))
    dt = torch.empty_like(t)
    dw = torch.empty(c, dtype=weight.dtype, device=t.device) if need_dw else None
    work = torch.empty(parts, c, dtype=torch.float32, device=t.device) if need_dw else None
    status = load_library().l32_rmsnorm_bwd(
        g.data_ptr(), t.data_ptr(), weight.data_ptr(), rms.data_ptr(), dt.data_ptr(),
        None if dw is None else dw.data_ptr(), None if work is None else work.data_ptr(),
        rows, c, parts, dtype_code(t), stream_of(t),
    )
    check(status, "rmsnorm backward kernel")
    rmsnorm_bwd_cuda.launches += 1
    return dt, dw


@counted("calls")
def rmsnorm_bwd_plain(g: torch.Tensor, t: torch.Tensor, weight: torch.Tensor, rms: torch.Tensor,
                      need_dw: bool = True):
    """The backward formula in PyTorch: ``(dt, dw)``."""
    rmsnorm_bwd_plain.calls += 1
    acc = acc_dtype(t)
    gf, tf, wf = g.to(acc), t.to(acc), weight.to(acc)
    inv = 1.0 / rms.to(acc)[..., None]
    gw = gf * wf
    dot = (gw * tf).sum(dim=-1, keepdim=True)
    dt = inv * (gw - tf * (dot * inv * inv / t.shape[-1]))
    dw = None
    if need_dw:
        dw = (gf * tf * inv).reshape(-1, t.shape[-1]).sum(dim=0).to(weight.dtype)
    return dt.to(t.dtype), dw
