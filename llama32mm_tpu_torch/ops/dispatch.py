"""Which implementation of a fused op runs: the hand-written CUDA kernel or
its plain PyTorch version.

- ``"auto"``: the kernel for a CUDA tensor, the plain version for a CPU
  tensor. On the card, ``"auto"`` is always the kernel.
- ``"cuda"``: the kernel; a CPU tensor raises.
- ``"torch"``: the plain version, on any device (tests and the kernel
  comparisons use it; the main path does not).

Under autograd (``needs_grad``) an op with a backward kernel runs as a
``torch.autograd.Function``: the kernel forward and the kernel backward for
``"cuda"``, both plain versions for ``"torch"``.
"""

from __future__ import annotations

import torch

_VALID = ("auto", "cuda", "torch")


def default_impl() -> str:
    """The implementation the port's entry points take by default:
    ``"auto"``, the hand kernels on the card (the JAX package's
    ``default_impl`` names its TPU's Pallas kernels there and XLA
    elsewhere; here ``"auto"`` is the plain version on the CPU)."""
    return "auto"


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """Resolve ``impl`` for an op whose operands live where ``x`` lives;
    returns ``"cuda"`` or ``"torch"``."""
    if impl not in _VALID:
        raise ValueError(f"impl must be one of {_VALID}, got {impl!r}")
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors, got a tensor on {x.device}")
    return impl


def needs_grad(*tensors) -> bool:
    """Whether an op on these operands is recorded for backward: grad mode is
    on and one of them requires a gradient. Such an op goes through its
    ``torch.autograd.Function`` (or a plain differentiable form), never a bare
    kernel call, whose output would carry no ``grad_fn``."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def not_in_slice(what: str):
    """Raise for a feature of the JAX package that the port does not run yet."""
    raise NotImplementedError(
        f"{what} is not ported to llama32mm_tpu_torch yet; see ROADMAP.md, queue 1"
    )
