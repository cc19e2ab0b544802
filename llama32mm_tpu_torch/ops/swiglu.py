"""Fused SwiGLU (counterpart of ``llama32mm_tpu/ops/swiglu.py``).

Weights are nn.Linear's ``[I, H]``; the JAX package stores ``[H, I]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from llama32mm_tpu_torch.ops.cuda.swiglu import fused_swiglu_cuda, fused_swiglu_plain
from llama32mm_tpu_torch.ops.dispatch import not_in_slice, resolve_impl


def fused_swiglu(
    x: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    b_gate: Optional[torch.Tensor] = None,
    b_up: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """``silu(x @ w_gate.T) * (x @ w_up.T)``: x ``[..., H]`` → ``[..., I]``."""
    if b_gate is not None or b_up is not None:
        not_in_slice("biased SwiGLU")
    if resolve_impl(impl, x) == "cuda":
        return fused_swiglu_cuda(x, w_gate, w_up)
    return fused_swiglu_plain(x, w_gate, w_up)
