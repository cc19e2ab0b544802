"""Fused SwiGLU (counterpart of ``llama32mm_tpu/ops/swiglu.py``).

Weights are nn.Linear's ``[I, H]``; the JAX package stores ``[H, I]``. Under
autograd it is a ``torch.autograd.Function``, as the Pallas custom VJP: the
backward kernel gives ``d_gate`` and ``d_up``, and ``dx = d_gate @ w_gate +
d_up @ w_up`` and the weight gradients are ``torch.matmul`` (the JAX package
leaves them to XLA); a weight gradient is computed only when that weight
requires one. Biases (configurations other than LLaMA's) take the plain
composition, as the JAX package's Pallas path composes them through XLA.

``swiglu_down`` is the JAX package's full-FFN decode fusion ``(silu(x @
w_gate) * (x @ w_up)) @ w_down`` as an op of its own; the model does not
call it (nor does the JAX package's).
"""

from __future__ import annotations

from typing import Optional

import math

import torch
from torch import nn

from llama32mm_tpu_torch.ops.cuda.swiglu import (
    fused_swiglu_bwd_cuda,
    fused_swiglu_bwd_plain,
    fused_swiglu_cuda,
    fused_swiglu_plain,
    swiglu_down_cuda,
    swiglu_down_plain,
)
from llama32mm_tpu_torch.ops.dispatch import needs_grad, resolve_impl


class _FusedSwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_gate, w_up, impl):
        cuda = impl == "cuda"
        if cuda:
            x = x.contiguous()
        out = (fused_swiglu_cuda if cuda else fused_swiglu_plain)(x, w_gate, w_up)
        ctx.save_for_backward(x, w_gate, w_up)
        ctx.cuda = cuda
        return out

    @staticmethod
    def backward(ctx, g):
        x, w_gate, w_up = ctx.saved_tensors
        bwd = fused_swiglu_bwd_cuda if ctx.cuda else fused_swiglu_bwd_plain
        d_gate, d_up = bwd(x, w_gate, w_up, g.contiguous())
        need_x, need_wg, need_wu, _ = ctx.needs_input_grad
        dx = torch.matmul(d_gate, w_gate) + torch.matmul(d_up, w_up) if need_x else None
        x2d = x.reshape(-1, x.shape[-1])
        dwg = torch.matmul(d_gate.reshape(-1, d_gate.shape[-1]).t(), x2d) if need_wg else None
        dwu = torch.matmul(d_up.reshape(-1, d_up.shape[-1]).t(), x2d) if need_wu else None
        return dx, dwg, dwu, None


def fused_swiglu(
    x: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    b_gate: Optional[torch.Tensor] = None,
    b_up: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """``silu(x @ w_gate.T + b_gate) * (x @ w_up.T + b_up)``: x ``[..., H]`` →
    ``[..., I]``."""
    impl = resolve_impl(impl, x)
    if b_gate is not None or b_up is not None:
        gate = torch.matmul(x, w_gate.t())
        up = torch.matmul(x, w_up.t())
        gate = gate if b_gate is None else gate + b_gate
        up = up if b_up is None else up + b_up
        return torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    if needs_grad(x, w_gate, w_up):
        return _FusedSwiGLU.apply(x, w_gate, w_up, impl)
    if impl == "cuda":
        return fused_swiglu_cuda(x, w_gate, w_up)
    return fused_swiglu_plain(x, w_gate, w_up)


def swiglu_down(
    x: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    b_gate: Optional[torch.Tensor] = None,
    b_up: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """The full FFN ``(silu(x @ w_gate.T) * (x @ w_up.T)) @ w_down.T``: x
    ``[..., H]``, w_gate/w_up ``[I, H]``, w_down ``[H, I]`` → ``[..., H]``.
    Meant for a few rows (decode). With a bias, or under autograd, it is
    ``fused_swiglu`` followed by a matmul."""
    impl = resolve_impl(impl, x)
    if b_gate is not None or b_up is not None or needs_grad(x, w_gate, w_up, w_down):
        return torch.matmul(fused_swiglu(x, w_gate, w_up, b_gate, b_up, impl), w_down.t())
    if impl == "cuda":
        return swiglu_down_cuda(x.contiguous(), w_gate, w_up, w_down)
    return swiglu_down_plain(x, w_gate, w_up, w_down)


class FusedSwiGLU(nn.Module):
    """Module-style parity with the reference ``FusedSwiGLU``: ``[hidden,
    inter]`` gate and up weights, U(±1/sqrt(hidden)) from ``generator``
    (one seeded 0 on ``device`` by default), optional zero biases."""

    def __init__(self, hidden_size: int, intermediate_size: int, bias: bool = False,
                 generator: Optional[torch.Generator] = None, dtype: torch.dtype = torch.float32,
                 impl: str = "auto", device="cuda"):
        super().__init__()
        gen = generator if generator is not None else torch.Generator(device).manual_seed(0)
        bound = 1.0 / math.sqrt(hidden_size)
        self.impl = impl

        def weight():
            w = torch.empty(intermediate_size, hidden_size, dtype=torch.float32, device=device)
            w.uniform_(-bound, bound, generator=gen)
            return nn.Parameter(w.to(dtype).t(), requires_grad=False)  # [hidden, inter]

        self.w_gate = weight()
        self.w_up = weight()
        zeros = [nn.Parameter(torch.zeros(intermediate_size, dtype=dtype, device=device),
                              requires_grad=False) if bias else None for _ in range(2)]
        self.b_gate, self.b_up = zeros

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_swiglu(x, self.w_gate.t(), self.w_up.t(), self.b_gate, self.b_up,
                            impl=self.impl)
