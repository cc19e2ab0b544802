"""Argument checks and launch plumbing shared by the kernel wrappers.

A wrapper takes CUDA tensors only: it checks device, dtype (bf16 or fp32),
shape and contiguity, allocates its output with ``torch.empty``, launches on
``torch.cuda.current_stream()`` and raises when the C entry reports an error.
Each wrapper carries a plain-integer ``launches`` count, each plain version a
``calls`` count, so a run can show which of the two it went through.
"""

from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The type a plain version computes in: fp32, or fp64 for fp64 inputs
    (the tests check the plain backward formulas in fp64 with gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}") from None


def require(name: str, t: torch.Tensor, like: torch.Tensor, shape=None, dtype=None) -> None:
    """Check that ``t`` is a contiguous CUDA tensor on ``like``'s device, of
    ``dtype`` (default: ``like``'s), and (when given) of ``shape``."""
    dtype = dtype or like.dtype
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got one on {t.device}")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def counted(attr: str):
    """Give a function a plain-integer counter attribute, starting at 0."""

    def deco(fn):
        setattr(fn, attr, 0)
        return fn

    return deco
