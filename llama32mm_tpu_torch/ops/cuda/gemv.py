"""Decode gemv: the CUDA kernels (``csrc/gemv.cu``) and their plain PyTorch
version. ``out[..., n] = sum_k x[..., k] * w[n, k]`` for at most
``MAX_ROWS`` rows of x, with the weight in nn.Linear's ``[N, K]`` layout.

The kernels replace ``gemv_pallas``, ``gemv_stacked_pallas`` (a layer of a
stacked weight is a pointer here) and ``gemv_t_pallas`` of
``llama32mm_tpu/ops/pallas/gemv.py``.

``gemv_cuda`` is the entry the model calls: ``l32_gemv`` routes the call by
its shape to the tensor-core kernel on x as it is (bf16 x, K a multiple of
32, 16-byte-aligned x and w) or else to the general route, and reports which
it launched. The general route runs on the tensor cores too: fp32 x (and
weights) as 3xTF32 ``mma.sync`` products, bf16 x after a pre-pass that
copies it to aligned rows of whole spans (``pad_workspace``), and weight
rows of any alignment or length read by words. ``gemv_tc_cuda`` and
``gemv_general_cuda`` count those launches, whoever made them; called
directly, each forces its own route.
"""

from __future__ import annotations

import ctypes

import torch

from llama32mm_tpu_torch.ops.cuda.build import check, load_library
from llama32mm_tpu_torch.ops.cuda.common import counted, dtype_code, require, stream_of

MAX_ROWS = 32

# l32_gemv's kernel argument: route by shape, or force one route.
ROUTED, GENERAL, TC = -1, 0, 1


def pad_workspace(x: torch.Tensor, rows: int, k: int):
    """The pre-pass's padded copy of x (rows of K rounded up to a span: 16 k
    fp32, 32 k bf16), or None where the kernels read x as it is (K a
    multiple of the span, x 16-byte aligned)."""
    span = 16 if x.dtype == torch.float32 else 32
    if k % span == 0 and x.data_ptr() % 16 == 0:
        return None
    return torch.empty(rows * (-(-k // span) * span), dtype=x.dtype, device=x.device)


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
    pad = pad_workspace(x, rows, k) if rows and n and kernel != TC else None
    launched = ctypes.c_int(-1)
    status = load_library().l32_gemv(
        x.data_ptr(), w.data_ptr(), None if pad is None else pad.data_ptr(), out.data_ptr(),
        rows, n, k, dtype_code(x), kernel, ctypes.byref(launched), stream_of(x),
    )
    check(status, "gemv kernel")
    if launched.value == TC:
        gemv_tc_cuda.launches += 1
    elif launched.value == GENERAL:
        gemv_general_cuda.launches += 1
    return out


@counted("launches")
def gemv_tc_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel on bf16 x as it is; raises for a call it does
    not take."""
    return _launch(x, w, TC)


@counted("launches")
def gemv_general_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The general route, any K and alignment: fp32 x on the 3xTF32 kernel,
    bf16 x padded by the pre-pass where it must be."""
    return _launch(x, w, GENERAL)


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
