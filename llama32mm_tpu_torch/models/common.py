"""Parameter holders shared by the towers. Weights are created empty on the
given device (no default init runs) and filled by ``init_uniform_`` /
``init_normal_`` from an explicit generator, or by ``convert.from_jax_params``.
No parameter requires a gradient until a trainer (``train/``) marks what it
trains."""

from __future__ import annotations

import copy
import math

import torch
from torch import nn


def empty_param(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype), requires_grad=False)


def copy_module(mod: nn.Module) -> nn.Module:
    """A shallow copy whose child modules, parameters and buffers can be
    replaced without touching ``mod``; the tensors themselves stay shared."""
    new = copy.copy(mod)
    for slot in ("_modules", "_parameters", "_buffers"):
        new.__dict__[slot] = dict(getattr(mod, slot))
    return new


class Linear(nn.Module):
    """``weight [out, in]`` (nn.Linear's layout) and an optional ``bias [out]``."""

    def __init__(self, n_in: int, n_out: int, bias: bool, device, dtype):
        super().__init__()
        self.weight = empty_param(n_out, n_in, device=device, dtype=dtype)
        self.bias = empty_param(n_out, device=device, dtype=dtype) if bias else None

    def init_(self, gen: torch.Generator) -> None:
        """torch nn.Linear's default distribution, U(±1/sqrt(fan_in)), for the
        weight and the bias, as the JAX package draws them."""
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.uniform_(-bound, bound, generator=gen)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=gen)


class QuantLinear(nn.Module):
    """A quantized ``[out, in]`` linear without bias (``ops/quant.py``):
    buffers ``q`` int8 ``[out, in]`` and ``scale`` fp32 ``[out]``, or ``q4``
    uint8 ``[out, in/2]`` and ``scale`` fp32 ``[out, in/group]``. Its
    ``weight`` is the ``{"q"|"q4", "scale"}`` dict, which the linears route
    to ``qlinear``, as the JAX tree holds that dict where the float weight
    was."""

    def __init__(self, qw: dict):
        super().__init__()
        for name, t in qw.items():
            self.register_buffer(name, t)

    @property
    def weight(self) -> dict:
        return dict(self._buffers)


class Norm(nn.Module):
    """A normalization's scale (ones) and optional shift (zeros)."""

    def __init__(self, dim: int, bias: bool, device, dtype):
        super().__init__()
        self.weight = empty_param(dim, device=device, dtype=dtype)
        self.bias = empty_param(dim, device=device, dtype=dtype) if bias else None

    def init_(self) -> None:
        self.weight.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()
