"""Linears of the decoder: the decode gemv for few rows, a plain matmul for
prefill, ``qlinear`` for a quantized weight.

With at most 32 rows of input (decode steps, the prefill's last-position
logits) a linear is weight-streaming-bound and runs the gemv kernel; with
more rows it is a GEMM and stays ``torch.matmul``, as the JAX package leaves
prefill linears to XLA. Under autograd every float linear is
``torch.matmul`` (the gemv kernel has no backward, and the JAX package routes
gemvs only at decode). A quantized weight (``{"q"|"q4", "scale"}``,
``ops/quant.py``) goes to ``qlinear`` at every row count; it is
inference-only, as in the JAX package, and raises under autograd.
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
from llama32mm_tpu_torch.ops.quant import is_quantized

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


def qlinear(x: torch.Tensor, qw: dict, impl: str = "auto") -> torch.Tensor:
    """``x [..., K] @ dequant(qw).T``. Routed by rows, not as the JAX package
    does: on the card at most ``MAX_ROWS`` rows go to the quantized gemv
    kernels and more to the dequantizing GEMM kernel; on the CPU both run
    their plain versions. An int4 weight's gemv is W4A16, or W4A8 when
    ``_INT4_VARIANT`` is ``"w4a8"``/``"w4a8b"``; more rows stay on the
    dequantizing GEMM either way, as the JAX package sends prefill rows to
    its dequantized matmul."""
    if needs_grad(x):
        raise NotImplementedError(
            "gradients through a quantized linear: quantized weights are inference-only, as in "
            "the JAX package (LoRA over a quantized base is not ported; see ROADMAP.md, queue 1)")
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
