"""Dequantizing GEMM for more than 32 rows: the CUDA kernel
(``csrc/qmatmul.cu``) and its plain PyTorch version. ``out = x @
dequant(w).T`` with the weight in nn.Linear's ``[N, K]`` orientation, either

- int8: ``q [N, K] int8`` and ``scale [N]`` fp32 (the scale multiplies the
  fp32 product, JAX's int8 ``qlinear``), replacing
  ``llama32mm_tpu/ops/pallas/quant_matmul.py::_kernel``; or
- int4: ``q4 [N, K/2] uint8`` (split-half per-group nibbles, ``u = q + 8``)
  and ``scale [N, K/g]`` fp32 (the weight is ``dequantize_weight`` rounded to
  x's dtype, JAX's rows > 64 path), replacing ``quant_matmul.py::_int4_kernel``.

The weight's dtype tells the two apart. ``qmatmul_cuda`` is the entry the
model calls: ``l32_qmatmul`` runs every call on one wgmma kernel and routes
it by its shape: bf16 x as it is where the kernel's tiles fit it (int8 with
K a multiple of 64 or int4 with g/2 a multiple of 32, 16-byte-aligned x and
weight), else the general route, a pre-pass that writes x into a workspace
(``workspace``: three exact bf16 planes for fp32 x, one for bf16; rows of
whole k-tiles; int4 in packed order) that the same kernel reads. It reports
which route it launched. ``qmatmul_tc_cuda`` (x as it is) and
``qmatmul_general_cuda`` (the general route) count those launches, whoever
made them; called directly, each forces its own route.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from llama32mm_tpu_torch.ops.cuda.build import check, load_library
from llama32mm_tpu_torch.ops.cuda.common import counted, dtype_code, stream_of
from llama32mm_tpu_torch.ops.cuda.qgemv import check_quant, int4_matmul_plain, int8_matmul_plain

# l32_qmatmul's kernel argument: route by shape, or force one route.
ROUTED, GENERAL, TC = -1, 0, 1


def reads_as_is(x: torch.Tensor, q: torch.Tensor, k: int, g: int) -> bool:
    """Whether the kernel reads x as it is: bf16 x whose k-tiles fit (int8:
    K a multiple of 64; int4: g/2 a multiple of 32), x and q 16-byte aligned."""
    tiles = k % 64 == 0 if g == 0 else (g // 2) % 32 == 0
    return (x.dtype == torch.bfloat16 and tiles and x.data_ptr() % 16 == 0
            and q.data_ptr() % 16 == 0)


def row_elems(k: int, g: int) -> int:
    """Elements of one workspace row: int8 K rounded up to a 64-k tile;
    int4 two packed halves of 32 per tile, each group of g/2 bytes given
    whole units of 16 (g/2 rounded up to 16)."""
    if g == 0:
        return -(-k // 64) * 64
    units = -(-(g // 2) // 16)
    return 64 * -(-(k // g) * units // 2)


def workspace(x: torch.Tensor, q: torch.Tensor, rows: int, k: int, g: int,
              kernel: int = ROUTED) -> Optional[torch.Tensor]:
    """The general route's pre-pass workspace (``[P, rows, row_elems]`` bf16,
    flat; P = 3 for fp32 x, 1 for bf16), or None where the call reads x as
    it is (routed there, or forced onto that route)."""
    if kernel == TC or (kernel == ROUTED and reads_as_is(x, q, k, g)):
        return None
    planes = 3 if x.dtype == torch.float32 else 1
    return torch.empty(planes * rows * row_elems(k, g), dtype=torch.bfloat16, device=x.device)


def _launch(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, kernel: int) -> torch.Tensor:
    rows, n, k, g = check_quant(x, q, scale)
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    xw = workspace(x, q, rows, k, g, kernel) if rows and n else None
    launched = ctypes.c_int(-1)
    status = load_library().l32_qmatmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), None if xw is None else xw.data_ptr(),
        out.data_ptr(), rows, n, k, g, dtype_code(x), kernel, ctypes.byref(launched),
        stream_of(x),
    )
    check(status, "dequantizing matmul kernel")
    if launched.value == TC:
        qmatmul_tc_cuda.launches += 1
    elif launched.value == GENERAL:
        qmatmul_general_cuda.launches += 1
    return out


@counted("launches")
def qmatmul_tc_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The wgmma kernel on bf16 x as it is; raises for a call it does not take."""
    return _launch(x, q, scale, TC)


@counted("launches")
def qmatmul_general_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The general route, any shape, alignment and x dtype: the pre-pass's
    planes, then the wgmma kernel."""
    return _launch(x, q, scale, GENERAL)


def qmatmul_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ dequant(q, scale).T`` → ``[..., N]`` in x's dtype,
    through the route the call's shape takes."""
    return _launch(x, q, scale, ROUTED)


@counted("calls")
def qmatmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8: ``(x @ q.T).float() * scale``; int4: ``x @ dequantize_weight.T``."""
    qmatmul_plain.calls += 1
    if q.dtype == torch.uint8:
        return int4_matmul_plain(x, q, scale)
    return int8_matmul_plain(x, q, scale)
