"""Fused add-RMSNorm (counterpart of ``llama32mm_tpu/ops/rmsnorm.py``).

Accumulates in fp32 as the Pallas kernel does, not in the input dtype as the
JAX package's XLA fallback does (PARITY.md row 5): the two agree in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from llama32mm_tpu_torch.ops.cuda.rmsnorm import fused_add_rmsnorm_cuda, fused_add_rmsnorm_plain
from llama32mm_tpu_torch.ops.dispatch import resolve_impl


def fused_add_rmsnorm(
    x: torch.Tensor,
    weight: torch.Tensor,
    eps: float = 1e-6,
    residual: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """``rmsnorm(x + residual) * weight`` over the last axis."""
    if resolve_impl(impl, x) == "cuda":
        return fused_add_rmsnorm_cuda(x, weight, eps, residual)
    return fused_add_rmsnorm_plain(x, weight, eps, residual)
