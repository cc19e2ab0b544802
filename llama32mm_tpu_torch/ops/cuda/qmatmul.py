"""Dequantizing GEMM for more than 32 rows: the CUDA kernel
(``csrc/qmatmul.cu``) and its plain PyTorch version. ``out = x @ dequant(w).T``
with the weight in nn.Linear's ``[N, K]`` orientation, either

- int8: ``q [N, K] int8`` and ``scale [N]`` fp32 (the scale multiplies the
  fp32 product, JAX's int8 ``qlinear``), replacing
  ``llama32mm_tpu/ops/pallas/quant_matmul.py::_kernel``; or
- int4: ``q4 [N, K/2] uint8`` (split-half per-group nibbles, ``u = q + 8``)
  and ``scale [N, K/g]`` fp32 (the weight is ``dequantize_weight`` rounded to
  x's dtype, JAX's rows > 64 path), replacing ``quant_matmul.py::_int4_kernel``.

The weight's dtype tells the two apart.
"""

from __future__ import annotations

import torch

from llama32mm_tpu_torch.ops.cuda.build import check, load_library
from llama32mm_tpu_torch.ops.cuda.common import counted, dtype_code, stream_of
from llama32mm_tpu_torch.ops.cuda.qgemv import check_quant, int4_matmul_plain, int8_matmul_plain


@counted("launches")
def qmatmul_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ dequant(q, scale).T`` → ``[..., N]`` in x's dtype."""
    rows, n, k, g = check_quant(x, q, scale)
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    status = load_library().l32_qmatmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, n, k, g,
        dtype_code(x), stream_of(x),
    )
    check(status, "dequantizing matmul kernel")
    qmatmul_cuda.launches += 1
    return out


@counted("calls")
def qmatmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8: ``(x @ q.T).float() * scale``; int4: ``x @ dequantize_weight.T``."""
    qmatmul_plain.calls += 1
    if q.dtype == torch.uint8:
        return int4_matmul_plain(x, q, scale)
    return int8_matmul_plain(x, q, scale)
