"""Fused SwiGLU forward: the CUDA kernel (``csrc/swiglu.cu``) and its plain
PyTorch version. ``silu(x @ w_gate.T) * (x @ w_up.T)`` with both weights in
nn.Linear's ``[I, H]`` layout; the kernel replaces
``llama32mm_tpu/ops/pallas/swiglu.py::_fwd_kernel``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from llama32mm_tpu_torch.ops.cuda.build import check, load_library
from llama32mm_tpu_torch.ops.cuda.common import counted, dtype_code, require, stream_of


@counted("launches")
def fused_swiglu_cuda(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """x ``[..., H]``, w_gate/w_up ``[I, H]`` → ``[..., I]``; gate and up
    accumulate in fp32 inside the kernel and are never written."""
    require("x", x, x)
    h = x.shape[-1]
    if w_gate.dim() != 2 or w_gate.shape[1] != h:
        raise ValueError(f"w_gate must be [I, {h}], got {tuple(w_gate.shape)}")
    require("w_gate", w_gate, x)
    require("w_up", w_up, x, w_gate.shape)
    inter = w_gate.shape[0]
    rows = x.numel() // h if h else 0
    out = torch.empty(*x.shape[:-1], inter, dtype=x.dtype, device=x.device)
    status = load_library().l32_swiglu_fwd(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), out.data_ptr(), rows, h, inter,
        dtype_code(x), stream_of(x),
    )
    check(status, "swiglu kernel")
    fused_swiglu_cuda.launches += 1
    return out


@counted("calls")
def fused_swiglu_plain(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """The same function in PyTorch: two matmuls in x's dtype, silu and the
    product in fp32, one rounding."""
    fused_swiglu_plain.calls += 1
    gate = torch.matmul(x, w_gate.t()).float()
    up = torch.matmul(x, w_up.t()).float()
    return (F.silu(gate) * up).to(x.dtype)
