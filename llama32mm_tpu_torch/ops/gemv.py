"""Linears of the decoder: the decode gemv for few rows, a plain matmul for
prefill.

With at most 32 rows of input (decode steps, the prefill's last-position
logits) a linear is weight-streaming-bound and runs the gemv kernel; with
more rows it is a GEMM and stays ``torch.matmul``, as the JAX package leaves
prefill linears to XLA.
"""

from __future__ import annotations

import torch

from llama32mm_tpu_torch.ops.cuda.gemv import MAX_ROWS, gemv_cuda, gemv_plain
from llama32mm_tpu_torch.ops.dispatch import resolve_impl


def linear(x: torch.Tensor, weight: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """``x [..., K] @ weight.T`` for ``weight [N, K]``."""
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    if rows > MAX_ROWS:
        return torch.matmul(x, weight.t())
    if resolve_impl(impl, x) == "cuda":
        return gemv_cuda(x.contiguous(), weight)
    return gemv_plain(x, weight)
