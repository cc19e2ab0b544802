"""Linears of the decoder: the decode gemv for few rows, a plain matmul for
prefill, ``qlinear`` for a quantized weight.

With at most 32 rows of input (decode steps, the prefill's last-position
logits) a linear is weight-streaming-bound and runs the gemv kernel; with
more rows it is a GEMM and stays ``torch.matmul``, as the JAX package leaves
prefill linears to XLA. Under autograd every float linear is
``torch.matmul`` (the gemv kernel has no backward, and the JAX package routes
gemvs only at decode). A quantized weight (``{"q"|"q4", "scale"}``,
``ops/quant.py``) goes to ``qlinear`` at every row count. Under autograd
(QLoRA: adapters over a frozen quantized base) ``qlinear`` is a
``torch.autograd.Function``: the same kernels forward, and a backward that
gives ``dx`` only, in the rounding order of JAX's autodiff through its
``qlinear`` (the quantized weight gets no gradient).
"""

from __future__ import annotations

import os

import torch

from llama32mm_tpu_torch.ops.cuda.gemv import MAX_ROWS, gemv_cuda, gemv_plain
from llama32mm_tpu_torch.ops.cuda.qgemv import (
    gemv_int4_cuda,
    gemv_int4_plain,
    gemv_int4_w4a8_cuda,
    gemv_int4_w4a8_plain,
    gemv_int8_cuda,
    gemv_int8_plain,
)
from llama32mm_tpu_torch.ops.cuda.qmatmul import qmatmul_cuda, qmatmul_plain
from llama32mm_tpu_torch.ops.dispatch import needs_grad, resolve_impl
from llama32mm_tpu_torch.ops.quant import dequantize_weight, is_quantized, unpack_int4

# The JAX package's int4 gemv variant, read from the environment at import as
# its ops/pallas/gemv.py reads it, and looked up at every call (so a caller or
# a test may set the module attribute). "pre", "post" and "post-cat" differ
# only in how a TPU unpacks and are one W4A16 kernel here; "w4a8" and
# "w4a8b" (the same math, batched for Mosaic) are the W4A8 kernel, which
# quantizes the activations per row to int8.
_INT4_VARIANT = os.environ.get("LLAMA32MM_INT4_VARIANT", "post")
_W4A8 = ("w4a8", "w4a8b")


def linear(x: torch.Tensor, weight, impl: str = "auto") -> torch.Tensor:
    """``x [..., K] @ weight.T`` for ``weight [N, K]``, float or quantized."""
    if is_quantized(weight):
        return qlinear(x, weight, impl)
    impl = resolve_impl(impl, x)
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    if rows > MAX_ROWS or needs_grad(x, weight):
        return torch.matmul(x, weight.t())
    if impl == "cuda":
        return gemv_cuda(x.contiguous(), weight)
    return gemv_plain(x, weight)


def _qlinear_forward(x: torch.Tensor, qw: dict, impl: str) -> torch.Tensor:
    if "q4" in qw:
        q, kernel, plain = qw["q4"], gemv_int4_cuda, gemv_int4_plain
        if _INT4_VARIANT in _W4A8:
            kernel, plain = gemv_int4_w4a8_cuda, gemv_int4_w4a8_plain
    else:
        q, kernel, plain = qw["q"], gemv_int8_cuda, gemv_int8_plain
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    if rows > MAX_ROWS:
        kernel, plain = qmatmul_cuda, qmatmul_plain
    if resolve_impl(impl, x) == "cuda":
        return kernel(x.contiguous(), q, qw["scale"])
    return plain(x, q, qw["scale"])


# JAX's int4 qlinear (ops/quant.py) dequantizes the weight above this many
# rows and takes a grouped einsum at or below it; its gradient follows suit.
_JAX_INT4_DEQUANT_ROWS = 64


def qlinear_dx(dy: torch.Tensor, qw: dict) -> torch.Tensor:
    """The input gradient of ``x @ dequant(qw).T`` for ``dy [..., N]``, as
    JAX's autodiff computes it through its ``qlinear``:

    - int8, ``((x @ q) · scale)`` with the product in x's dtype:
      ``((dy · scale) in fp32, rounded to the dtype) @ q``;
    - int4 above 64 rows, ``x @ dequant(qw)``: ``dy @ dequant(qw)``;
    - int4 at most 64 rows, the per-group einsum (partial products in x's
      dtype, scaled in fp32): ``d_part[..., n, o] = dy[..., o] · scale[o, n]``
      rounded to the dtype, then ``dx[..., n, i] = Σ_o d_part · q[o, n, i]``.

    The products are plain ``torch`` (the JAX package leaves them to XLA)."""
    dtype = dy.dtype
    scale = qw["scale"]
    if "q4" in qw:
        rows = dy.numel() // dy.shape[-1] if dy.shape[-1] else 0
        if rows > _JAX_INT4_DEQUANT_ROWS:
            return torch.matmul(dy, dequantize_weight(qw, dtype))
        n, ng = scale.shape
        vals = unpack_int4(qw["q4"], ng).reshape(n, ng, -1).to(dtype)  # [N, ng, g]
        d_part = (dy.float()[..., None, :] * scale.t()).to(dtype)  # [..., ng, N]
        dx = torch.einsum("...no,oni->...ni", d_part, vals)
        return dx.reshape(*dy.shape[:-1], -1)
    return torch.matmul((dy.float() * scale).to(dtype), qw["q"].to(dtype))


class _QLinear(torch.autograd.Function):
    """``qlinear`` under autograd: the inference routing forward, ``dx`` back."""

    @staticmethod
    def forward(ctx, x, q, scale, key, impl):
        qw = {key: q, "scale": scale}
        ctx.save_for_backward(q, scale)
        ctx.key = key
        with torch.no_grad():
            return _qlinear_forward(x, qw, impl)

    @staticmethod
    def backward(ctx, dy):
        q, scale = ctx.saved_tensors
        dx = qlinear_dx(dy, {ctx.key: q, "scale": scale}) if ctx.needs_input_grad[0] else None
        return dx, None, None, None, None


def qlinear(x: torch.Tensor, qw: dict, impl: str = "auto") -> torch.Tensor:
    """``x [..., K] @ dequant(qw).T``. Routed by rows, not as the JAX package
    does: on the card at most ``MAX_ROWS`` rows go to the quantized gemv
    kernels and more to the dequantizing GEMM kernel; on the CPU both run
    their plain versions. An int4 weight's gemv is W4A16, or W4A8 when
    ``_INT4_VARIANT`` is ``"w4a8"``/``"w4a8b"``; more rows stay on the
    dequantizing GEMM either way, as the JAX package sends prefill rows to
    its dequantized matmul. When ``x`` needs a gradient the call records a
    backward for ``x`` alone (``qlinear_dx``)."""
    if needs_grad(x):
        key = "q4" if "q4" in qw else "q"
        return _QLinear.apply(x, qw[key], qw["scale"], key, impl)
    return _qlinear_forward(x, qw, impl)
