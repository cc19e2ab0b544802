"""Decode gemv: the CUDA kernels (``csrc/gemv.cu``) and their plain PyTorch
version. ``out[..., n] = sum_k x[..., k] * w[n, k]`` for at most
``MAX_ROWS`` rows of x, with the weight in nn.Linear's ``[N, K]`` layout.

The kernels replace ``gemv_pallas``, ``gemv_stacked_pallas`` (a layer of a
stacked weight is a pointer here) and ``gemv_t_pallas`` of
``llama32mm_tpu/ops/pallas/gemv.py``.

``gemv_cuda`` is the entry the model calls: ``l32_gemv`` routes the call by
its shape to the tensor-core kernel (bf16 x, K a multiple of 32,
16-byte-aligned x and w) or else to the CUDA-core kernel, and reports which
one it launched. ``gemv_tc_cuda`` (tensor cores) and ``gemv_simt_cuda``
(CUDA cores) count those launches, whoever made them; called directly, each
forces its own kernel.
"""

from __future__ import annotations

import ctypes

import torch

from llama32mm_tpu_torch.ops.cuda.build import check, load_library
from llama32mm_tpu_torch.ops.cuda.common import counted, dtype_code, require, stream_of

MAX_ROWS = 32

# l32_gemv's kernel argument: route by shape, or force one kernel.
ROUTED, SIMT, TC = -1, 0, 1


def _launch(x: torch.Tensor, w: torch.Tensor, kernel: int) -> torch.Tensor:
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
    launched = ctypes.c_int(-1)
    status = load_library().l32_gemv(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, n, k, dtype_code(x), kernel,
        ctypes.byref(launched), stream_of(x),
    )
    check(status, "gemv kernel")
    if launched.value == TC:
        gemv_tc_cuda.launches += 1
    elif launched.value == SIMT:
        gemv_simt_cuda.launches += 1
    return out


@counted("launches")
def gemv_tc_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel; raises for a call it does not take."""
    return _launch(x, w, TC)


@counted("launches")
def gemv_simt_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The CUDA-core kernel, any K and alignment, bf16 or fp32."""
    return _launch(x, w, SIMT)


def gemv_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w.T`` for ``w [N, K]`` and at most 32 rows of x, fp32
    accumulation, output in x's dtype, through the kernel the call's shape
    routes to."""
    return _launch(x, w, ROUTED)


@counted("calls")
def gemv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` in PyTorch (bf16 products accumulate in fp32 in cuBLAS)."""
    gemv_plain.calls += 1
    return torch.matmul(x, w.t())
