"""Quantized decode gemvs: the CUDA kernels (``csrc/qgemv.cu``) and their
plain PyTorch versions, for at most ``MAX_ROWS`` rows of x and weights in
nn.Linear's ``[N, K]`` orientation.

- int8 (``gemv_int8_*``): ``q [N, K] int8`` with a per-output-channel fp32
  ``scale [N]``; ``out = (x @ q.T) * scale``, the scale applied once to the
  fp32 sum. Replaces ``_qstacked_kernel`` (``int8_gemv_stacked_pallas``)
  and ``_qkernel`` (``int8_gemv_pallas``) of
  ``llama32mm_tpu/ops/pallas/gemv.py``. ``gemv_int8_cuda`` is the entry the
  model calls: ``l32_gemv_int8`` runs every call on the tensor cores
  (``mma.sync``, exact bf16 weights): bf16 x with K a multiple of 64 and
  16-byte-aligned x and q as it is, anything else after a pre-pass that
  writes x as bf16 planes padded to whole 64-k spans (``int8_planes``: three
  for fp32 x, ``split_bf16_planes``), weight rows of any alignment or length
  read by words. It reports which route it launched; ``gemv_int8_tc_cuda``
  and ``gemv_int8_general_cuda`` count those launches and, called directly,
  force their own route.
- int4 W4A16 (``gemv_int4_*``): ``q4 [N, K/2] uint8`` in the split-half
  per-group nibble packing with the ``u = q + 8`` offset and fp32
  ``scale [N, K/g]``; ``out = x @ dequant(q4, scale).T``. Replaces
  ``_int4_kernel_post`` (``variant="post"``/``"post-cat"``) and folds
  ``_int4_kernel`` (``"pre"``): the three differ only in how a TPU unpacks.
  ``gemv_int4_cuda`` runs every call on the tensor cores (``mma.sync``):
  bf16 x with g/2 a multiple of 16 and 16-byte-aligned x and q4 as it is,
  anything else after a pre-pass that writes x as bf16 planes
  (``split_bf16_planes``: three for fp32 x) in the order the kernel reads.
- int4 W4A8 (``gemv_int4_w4a8_*``): the same weights against activations
  quantized per row to int8, ``x ≈ ax·xq`` with ``ax = max|x_row| / 127``
  (1 for an all-zero row) and ``xq = clamp(round(x / ax), -127, 127)``
  rounding half to even; ``out = ax · Σ_g scale[n, g] · Σ_{k∈g} xq·q``, exact
  integers per group. Replaces ``_int4_kernel_w4a8`` (``variant="w4a8"``)
  and folds ``_int4_kernel_w4a8b`` (``"w4a8b"``, the same math batched for
  Mosaic). The activation rounding is the one numerical change against
  W4A16. ``gemv_int4_w4a8_cuda`` quantizes the rows, then runs the dot on
  the tensor cores (``mma.sync`` s8) at every group size, alignment and x
  dtype.
"""

from __future__ import annotations

import ctypes

import torch

from llama32mm_tpu_torch.ops.cuda.build import check, load_library
from llama32mm_tpu_torch.ops.cuda.common import counted, dtype_code, require, stream_of
from llama32mm_tpu_torch.ops.cuda.gemv import GENERAL, MAX_ROWS, ROUTED, TC
from llama32mm_tpu_torch.ops.quant import dequantize_weight, unpack_int4


def check_quant(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor):
    """Validate a quantized linear's CUDA operands; return ``(rows, n, k,
    group_size)``, the group size 0 for int8 (the weight's dtype, int8 or
    packed uint8, tells the two apart)."""
    require("x", x, x)
    k = x.shape[-1]
    packed = q.dtype == torch.uint8
    n = q.shape[0] if q.dim() == 2 else -1
    require("q", q, x, (n, k // 2 if packed else k), torch.uint8 if packed else torch.int8)
    groups = scale.shape[-1] if packed else 1
    require("scale", scale, x, (n, groups) if packed else (n,), torch.float32)
    if packed and (groups == 0 or k % groups or (k // groups) % 2):
        raise ValueError(f"K={k} must split into {groups} groups of even size")
    rows = x.numel() // k if k else 0
    return rows, n, k, k // groups if packed else 0


def _gemv_rows(x, q, scale, packed: bool):
    if (q.dtype == torch.uint8) != packed:
        raise TypeError(f"this gemv takes {'uint8' if packed else 'int8'} weights, got {q.dtype}")
    rows, n, k, g = check_quant(x, q, scale)
    if rows > MAX_ROWS:
        raise ValueError(f"the quantized gemv takes at most {MAX_ROWS} rows, got {rows}")
    return rows, n, k, g


def int8_planes(x: torch.Tensor, rows: int, k: int):
    """The int8 pre-pass's bf16 planes (three for fp32 x, one for bf16; rows
    of K rounded up to 64), or None where the kernel reads x as it is (bf16
    x, K a multiple of 64, x 16-byte aligned)."""
    if x.dtype == torch.bfloat16 and k % 64 == 0 and x.data_ptr() % 16 == 0:
        return None
    planes = 3 if x.dtype == torch.float32 else 1
    return torch.empty(planes * rows * (-(-k // 64) * 64), dtype=torch.bfloat16, device=x.device)


def _int8(x, q, scale, kernel: int) -> torch.Tensor:
    rows, n, k, _ = _gemv_rows(x, q, scale, packed=False)
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    planes = int8_planes(x, rows, k) if rows and n and kernel != TC else None
    launched = ctypes.c_int(-1)
    status = load_library().l32_gemv_int8(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(),
        None if planes is None else planes.data_ptr(), out.data_ptr(), rows, n, k,
        dtype_code(x), kernel, ctypes.byref(launched), stream_of(x),
    )
    check(status, "int8 gemv kernel")
    if launched.value == TC:
        gemv_int8_tc_cuda.launches += 1
    elif launched.value == GENERAL:
        gemv_int8_general_cuda.launches += 1
    return out


def gemv_int8_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(x [..., K] @ q.T) * scale`` for ``q [N, K] int8``, at most 32 rows
    of x, fp32 accumulation, output in x's dtype, through the route the
    call's shape takes."""
    return _int8(x, q, scale, ROUTED)


@counted("launches")
def gemv_int8_tc_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The tensor-core int8 gemv on bf16 x as it is; raises for a call it
    does not take."""
    return _int8(x, q, scale, TC)


@counted("launches")
def gemv_int8_general_cuda(x: torch.Tensor, q: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """The int8 gemv's general route, any K and alignment: x as the
    pre-pass's bf16 planes (three for fp32 x) where it must be."""
    return _int8(x, q, scale, GENERAL)


@counted("calls")
def gemv_int8_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int8 gemv in PyTorch: the product in x's dtype with the weight
    converted exactly, the scale on its fp32 result (JAX's int8 ``qlinear``)."""
    gemv_int8_plain.calls += 1
    return int8_matmul_plain(x, q, scale)


def packed_half(k: int) -> int:
    """Elements of one half of a packed x row (``csrc/qgemv.cu``): K/2
    rounded up to whole 16-byte weight spans."""
    return (k // 2 + 15) // 16 * 16


def split_bf16_planes(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` as three bf16 planes ``[3, *x.shape]`` with ``x = b0 + b1 +
    b2`` exactly (for normal x whose low part stays normal: |x| above about
    2^-110): each plane is the top 16 bits of what the planes before it
    leave, truncated, so none rounds up to inf near the fp32 maximum. The
    W4A16 pre-pass (``split_rows_kernel``) computes it on the card."""
    r, planes = x.float(), []
    for _ in range(3):
        top = (r.view(torch.int32) & -65536).view(torch.float32)  # bits 0xFFFF0000
        planes.append(top.to(torch.bfloat16))  # exact: the low 16 bits are zero
        r = r - top
    return torch.stack(planes)


def _int4_planes(x, q4, rows, k, g):
    """The pre-pass's workspace, or None where the kernel reads x as it is
    (bf16 x, 16-byte-aligned x and q4, g/2 a multiple of 16)."""
    if (x.dtype == torch.bfloat16 and (g // 2) % 16 == 0 and x.data_ptr() % 16 == 0
            and q4.data_ptr() % 16 == 0):
        return None
    planes = 3 if x.dtype == torch.float32 else 1
    return torch.empty(planes * rows * 2 * packed_half(k), dtype=torch.bfloat16, device=x.device)


@counted("launches")
def gemv_int4_cuda(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ dequant(q4, scale).T`` for ``q4 [N, K/2] uint8`` and
    ``scale [N, K/g]``, at most 32 rows of x, on the tensor cores: fp32 sums
    with the group scale applied to each, output in x's dtype, each row's
    bits independent of the other rows. fp32 x is summed as three exact bf16
    planes."""
    rows, n, k, g = _gemv_rows(x, q4, scale, packed=True)
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    planes = _int4_planes(x, q4, rows, k, g) if rows and n else None
    status = load_library().l32_gemv_int4(
        x.data_ptr(), q4.data_ptr(), scale.data_ptr(),
        None if planes is None else planes.data_ptr(), out.data_ptr(), rows, n, k, g,
        dtype_code(x), stream_of(x),
    )
    check(status, "int4 gemv kernel")
    gemv_int4_cuda.launches += 1
    return out


@counted("calls")
def gemv_int4_plain(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int4 gemv in PyTorch: dequantize to x's dtype, then one matmul."""
    gemv_int4_plain.calls += 1
    return int4_matmul_plain(x, q4, scale)


@counted("launches")
def gemv_int4_w4a8_cuda(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """W4A8: ``x [..., K]`` quantized per row to int8 by a first kernel, then
    int32 dots with ``q4 [N, K/2]`` per group on the tensor cores, ``scale
    [N, K/g]``, at most 32 rows of x; output in x's dtype."""
    rows, n, k, g = _gemv_rows(x, q4, scale, packed=True)
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    xq = torch.empty(rows * 2 * packed_half(k), dtype=torch.int8, device=x.device)
    ax = torch.empty(rows, dtype=torch.float32, device=x.device)
    status = load_library().l32_gemv_int4_w4a8(
        x.data_ptr(), q4.data_ptr(), scale.data_ptr(), xq.data_ptr(), ax.data_ptr(),
        out.data_ptr(), rows, n, k, g, dtype_code(x), stream_of(x),
    )
    check(status, "int4 W4A8 gemv kernel")
    gemv_int4_w4a8_cuda.launches += 1
    return out


@counted("calls")
def gemv_int4_w4a8_plain(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """W4A8 in PyTorch: the row quantization, exact per-group integer dots
    (fp64 holds them exactly), the group scales and ``ax`` in fp32."""
    gemv_int4_w4a8_plain.calls += 1
    k = x.shape[-1]
    n, ng = scale.shape
    xq, ax = quantize_rows_int8(x.reshape(-1, k))
    w = unpack_int4(q4, ng).to(torch.float64).reshape(n, ng, k // ng)
    dots = torch.einsum("rgk,ngk->rng", xq.to(torch.float64).reshape(-1, ng, k // ng), w)
    out = (dots.float() * scale).sum(dim=-1) * ax[:, None]
    return out.to(x.dtype).reshape(*x.shape[:-1], n)


def quantize_rows_int8(x2d: torch.Tensor):
    """``[R, K]`` → (int8 ``xq [R, K]``, fp32 ``ax [R]``), the W4A8
    activation quantization (true divisions, round half to even)."""
    xf = x2d.float()
    ax = xf.abs().amax(dim=1) / 127.0
    ax = torch.where(ax > 0, ax, torch.ones_like(ax))
    xq = torch.clamp(torch.round(xf / ax[:, None]), -127, 127).to(torch.int8)
    return xq, ax


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (torch.matmul(x, q.to(x.dtype).t()).float() * scale).to(x.dtype)


def int4_matmul_plain(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, dequantize_weight({"q4": q4, "scale": scale}, x.dtype).t())
