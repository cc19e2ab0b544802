"""Fused add-RMSNorm (counterpart of ``llama32mm_tpu/ops/rmsnorm.py``).

Accumulates in fp32 as the Pallas kernel does, not in the input dtype as the
JAX package's XLA fallback does (PARITY.md row 5): the two agree in fp32.
Without autograd it runs the inference forward; under autograd it is a
``torch.autograd.Function``: the training forward (which saves ``t = x +
residual`` and the fp32 ``rms``) and the backward, with the same ``dt`` for x
and the residual and no ``+1e-6`` on rms (PARITY §2.9 #13, #16), as the
Pallas custom VJP.

``LLAMARMSNorm`` is the reference's module (``Model/model.py:158-171``):
an ``nn.Module`` holding the ``[emb_dim]`` scale, whose ``forward(x,
residual=None)`` is ``fused_add_rmsnorm`` (on the card, ``rmsnorm.cu``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from llama32mm_tpu_torch.ops.cuda.rmsnorm import (
    fused_add_rmsnorm_cuda,
    fused_add_rmsnorm_plain,
    rmsnorm_bwd_cuda,
    rmsnorm_bwd_plain,
    rmsnorm_fwd_train_cuda,
    rmsnorm_fwd_train_plain,
)
from llama32mm_tpu_torch.ops.dispatch import needs_grad, resolve_impl


class _FusedAddRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, residual, eps, impl):
        cuda = impl == "cuda"
        fwd = rmsnorm_fwd_train_cuda if cuda else rmsnorm_fwd_train_plain
        if cuda:
            x = x.contiguous()
            residual = None if residual is None else residual.contiguous()
        out, t, rms = fwd(x, weight, eps, residual)
        ctx.save_for_backward(t, weight, rms)
        ctx.cuda = cuda
        return out

    @staticmethod
    def backward(ctx, g):
        t, weight, rms = ctx.saved_tensors
        bwd = rmsnorm_bwd_cuda if ctx.cuda else rmsnorm_bwd_plain
        dt, dw = bwd(g.contiguous(), t, weight, rms, need_dw=ctx.needs_input_grad[1])
        d_res = dt if ctx.needs_input_grad[2] else None
        return dt, dw, d_res, None, None


def fused_add_rmsnorm(
    x: torch.Tensor,
    weight: torch.Tensor,
    eps: float = 1e-6,
    residual: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """``rmsnorm(x + residual) * weight`` over the last axis."""
    impl = resolve_impl(impl, x)
    if needs_grad(x, weight, residual):
        return _FusedAddRMSNorm.apply(x, weight, residual, eps, impl)
    if impl == "cuda":
        return fused_add_rmsnorm_cuda(x, weight, eps, residual)
    return fused_add_rmsnorm_plain(x, weight, eps, residual)


class LLAMARMSNorm(nn.Module):
    """Module-style parity with the reference ``LLAMARMSNorm``: the
    ``[emb_dim]`` scale (ones, no gradient until a trainer asks for one) and
    the fused op."""

    def __init__(self, emb_dim: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 impl: str = "auto", device="cuda"):
        super().__init__()
        self.eps = eps
        self.impl = impl
        self.weight = nn.Parameter(torch.ones(emb_dim, dtype=dtype, device=device),
                                   requires_grad=False)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        return fused_add_rmsnorm(x, self.weight, self.eps, residual=residual, impl=self.impl)
