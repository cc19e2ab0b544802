"""Decode gemv: the CUDA kernel (``csrc/gemv.cu``) and its plain PyTorch
version. ``out[..., n] = sum_k x[..., k] * w[n, k]`` for at most
``MAX_ROWS`` rows of x, with the weight in nn.Linear's ``[N, K]`` layout.

The kernel replaces ``gemv_pallas``, ``gemv_stacked_pallas`` (a layer of a
stacked weight is a pointer here) and ``gemv_t_pallas`` of
``llama32mm_tpu/ops/pallas/gemv.py``.
"""

from __future__ import annotations

import torch

from llama32mm_tpu_torch.ops.cuda.build import check, load_library
from llama32mm_tpu_torch.ops.cuda.common import counted, dtype_code, require, stream_of

MAX_ROWS = 32


@counted("launches")
def gemv_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w.T`` for ``w [N, K]`` and at most 32 rows of x, fp32
    accumulation, output in x's dtype."""
    require("x", x, x)
    k = x.shape[-1]
    if w.dim() != 2 or w.shape[1] != k:
        raise ValueError(f"w must be [N, {k}], got {tuple(w.shape)}")
    require("w", w, x)
    rows = x.numel() // k if k else 0
    if rows > MAX_ROWS:
        raise ValueError(f"gemv takes at most {MAX_ROWS} rows, got {rows}")
    n = w.shape[0]
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    status = load_library().l32_gemv(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, n, k, dtype_code(x), stream_of(x)
    )
    check(status, "gemv kernel")
    gemv_cuda.launches += 1
    return out


@counted("calls")
def gemv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` in PyTorch (bf16 products accumulate in fp32 in cuBLAS)."""
    gemv_plain.calls += 1
    return torch.matmul(x, w.t())
