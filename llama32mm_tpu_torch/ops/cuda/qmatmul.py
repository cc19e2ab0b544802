"""Dequantizing GEMM for more than 32 rows: the CUDA kernels
(``csrc/qmatmul.cu``) and their plain PyTorch version. ``out = x @
dequant(w).T`` with the weight in nn.Linear's ``[N, K]`` orientation, either

- int8: ``q [N, K] int8`` and ``scale [N]`` fp32 (the scale multiplies the
  fp32 product, JAX's int8 ``qlinear``), replacing
  ``llama32mm_tpu/ops/pallas/quant_matmul.py::_kernel``; or
- int4: ``q4 [N, K/2] uint8`` (split-half per-group nibbles, ``u = q + 8``)
  and ``scale [N, K/g]`` fp32 (the weight is ``dequantize_weight`` rounded to
  x's dtype, JAX's rows > 64 path), replacing ``quant_matmul.py::_int4_kernel``.

The weight's dtype tells the two apart. ``qmatmul_cuda`` is the entry the
model calls: ``l32_qmatmul`` routes the call by its shape to the wgmma kernel
(bf16 x, int8 with K a multiple of 64 or int4 with g/2 a multiple of 32,
16-byte-aligned x and weight), else to the wmma kernel for bf16 or the SIMT
loop for fp32, and reports which one it launched. ``qmatmul_tc_cuda`` (the
wgmma kernel) and ``qmatmul_wmma_cuda`` (wmma or SIMT) count those launches,
whoever made them; called directly, each forces its own kernel.
"""

from __future__ import annotations

import ctypes

import torch

from llama32mm_tpu_torch.ops.cuda.build import check, load_library
from llama32mm_tpu_torch.ops.cuda.common import counted, dtype_code, stream_of
from llama32mm_tpu_torch.ops.cuda.qgemv import check_quant, int4_matmul_plain, int8_matmul_plain

# l32_qmatmul's kernel argument: route by shape, or force one kernel.
ROUTED, SIMT, WMMA, WGMMA = -1, 0, 1, 2


def _launch(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, kernel: int) -> torch.Tensor:
    rows, n, k, g = check_quant(x, q, scale)
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    launched = ctypes.c_int(-1)
    status = load_library().l32_qmatmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, n, k, g,
        dtype_code(x), kernel, ctypes.byref(launched), stream_of(x),
    )
    check(status, "dequantizing matmul kernel")
    if launched.value == WGMMA:
        qmatmul_tc_cuda.launches += 1
    elif launched.value >= 0:
        qmatmul_wmma_cuda.launches += 1
    return out


@counted("launches")
def qmatmul_tc_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The wgmma kernel; raises for a call it does not take."""
    return _launch(x, q, scale, WGMMA)


@counted("launches")
def qmatmul_wmma_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The wmma kernel (bf16 x) or the SIMT loop (fp32 x), any shape."""
    return _launch(x, q, scale, WMMA if x.dtype == torch.bfloat16 else SIMT)


def qmatmul_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ dequant(q, scale).T`` → ``[..., N]`` in x's dtype,
    through the kernel the call's shape routes to."""
    return _launch(x, q, scale, ROUTED)


@counted("calls")
def qmatmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8: ``(x @ q.T).float() * scale``; int4: ``x @ dequantize_weight.T``."""
    qmatmul_plain.calls += 1
    if q.dtype == torch.uint8:
        return int4_matmul_plain(x, q, scale)
    return int8_matmul_plain(x, q, scale)
