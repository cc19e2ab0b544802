"""Adam, AdamW and Adafactor with optax's update rules, optionally after
``clip_by_global_norm``, stepped one parameter at a time.

The JAX package trains with optax, which is XLA there, not a Pallas kernel;
this is plain PyTorch that follows optax's arithmetic:

- ``m = (1 - b1) g + b1 m``, ``v = (1 - b2) g^2 + b2 v``, bias corrections
  ``1 - b^t`` with ``t`` the update count, ``u = m_hat / (sqrt(v_hat) + eps)``
  (``eps_root`` 0); AdamW adds ``weight_decay * p`` to ``u`` for every
  parameter (no mask); the parameter moves by ``-lr * u``;
- ``learning_rate`` is a float or a callable of the number of updates done
  (an optax schedule);
- ``clip_by_global_norm(max_norm)`` leaves the gradients as they are when
  their global norm is below ``max_norm`` and otherwise scales each by
  ``max_norm / norm`` (``(g / norm) * max_norm``); unlike
  ``torch.nn.utils.clip_grad_norm_`` it adds nothing to the norm.

Adafactor is ``optax.adafactor`` as the JAX package builds it
(``multiply_by_parameter_scale=False``, ``momentum=None``) with optax's other
defaults: the second moment is factored for a parameter with two dimensions
of at least 128 (a row vector and a column vector, over its two largest
dimensions), kept whole otherwise; decay ``1 - t^-0.8`` at update ``t``;
1e-30 added to ``g²``; the update ``g / sqrt(v)`` then clipped to an RMS of
at most 1 per block, scaled by the learning rate, plus
``weight_decay_rate * p`` when set, subtracted. A block is one leaf of the
JAX tree: the port keeps one module per layer where JAX stacks the layers,
so ``stacked_leaf`` maps a parameter name to its JAX leaf and the clip's RMS
runs over all of a stack's layers.

Parameters are updated in place, one at a time, so the temporaries of a step
are those of the largest parameter rather than of the whole model.

Sharded parameters (``layouts``: ``{name: parallel.Placement}``, each
tensor a rank's slice): every reduction the rules make over a whole tensor
or the whole tree is made over the mesh. The global norm sums each rank's
squares, a tensor held by several ranks counted once (its sum divided by
its replicas), over ``tp``, ``dp``, ``sp`` and ``pp``; Adafactor's factoring follows the
whole shape, its row and column means over a split dim are summed over the
split's axis, and each block's RMS sums over the mesh as the norm does.
Those sums of squares accumulate in fp64, so the norm and the RMS round to
the same fp32 bits however the tensors are split: with bf16 compute, an
fp32 sum's order would move the clip's last bits, and the masters' bf16
casts would turn them into different weights. The result equals the
one-device optimizer's up to the order of Adafactor's means.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch

from llama32mm_tpu_torch.parallel.mesh import AXIS_DP, AXIS_PP, AXIS_SP, AXIS_TP
from llama32mm_tpu_torch.parallel.sharding import set_placement

_NORM_AXES = (AXIS_TP, AXIS_DP, AXIS_SP, AXIS_PP)  # the order of the norm's sums


def _weight(pl) -> float:
    """``1 / `` the number of ranks that hold the same slice (1 unsharded)."""
    return 1.0 if pl is None else 1.0 / math.prod(pl.replicas(axis) for axis in _NORM_AXES)


def _mesh_sum(x: torch.Tensor, layouts: Optional[dict]) -> torch.Tensor:
    """``x`` (per-rank partial sums, each already divided by its replicas)
    summed over the mesh of ``layouts`` (no call on one device)."""
    pl = next((p for p in (layouts or {}).values() if p is not None), None)
    if pl is None:
        return x
    for axis in _NORM_AXES:
        x = pl.mesh.all_reduce(x, axis)
    return x


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x``'s fp32 squares, accumulated in fp64: the same bits
    (after rounding to fp32) however the tensor is split and summed over
    the mesh, where an fp32 sum's order moves its last bits."""
    return x.float().square().sum(dtype=torch.float64)


def _global_norm_clip(grads: dict, max_norm: Optional[float], layouts: Optional[dict] = None):
    """optax's ``clip_by_global_norm``: the norm to divide by (fp32), or
    None when the global norm is below ``max_norm`` (or there is no clip)."""
    if max_norm is None:
        return None
    layouts = layouts or {}
    sq = sum(_sum_squares(g) * _weight(layouts.get(name)) for name, g in grads.items())
    norm = torch.sqrt(_mesh_sum(sq, layouts)).float()
    return None if bool(norm < max_norm) else norm


@dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the update count and the moments, keyed
    like the parameters."""

    count: int
    mu: dict
    nu: dict


class Adam:
    def __init__(self, learning_rate: Union[float, Callable[[int], float]] = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: Optional[float] = None, max_grad_norm: Optional[float] = None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm

    def init(self, params: dict, layouts: Optional[dict] = None) -> AdamState:
        """Zero moments shaped like ``params``; ``layouts`` (as in ``step``)
        notes each moment's placement, its parameter's."""
        layouts = layouts or {}

        def zeros():
            return {name: set_placement(torch.zeros_like(p, requires_grad=False),
                                        layouts.get(name)) for name, p in params.items()}

        return AdamState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: AdamState,
             layouts: Optional[dict] = None) -> AdamState:
        """Update ``params`` in place from ``grads`` (same keys; a gradient
        may be of a lower precision than its parameter) and return the new
        state (its moments are updated in place). ``layouts``: each sharded
        parameter's placement (see the module's notes)."""
        clip = _global_norm_clip(grads, self.max_grad_norm, layouts)
        lr = self.learning_rate(state.count) if callable(self.learning_rate) else self.learning_rate
        count = state.count + 1
        bc1, bc2 = 1.0 - self.b1**count, 1.0 - self.b2**count
        for name, p in params.items():
            g = grads[name].to(p.dtype)
            if clip is not None:
                g = (g / clip.to(p.dtype)) * self.max_grad_norm
            m, v = state.mu[name], state.nu[name]
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            del g
            u = m / bc1
            u.div_((v / bc2).sqrt_().add_(self.eps))
            if self.weight_decay:  # optax adds wd * p; 0 * p adds nothing
                u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)
        return AdamState(count=count, mu=state.mu, nu=state.nu)


def _whole(p: torch.Tensor, name: str, layouts: Optional[dict]) -> tuple:
    """The whole shape of the parameter whose (local) tensor is ``p``."""
    pl = (layouts or {}).get(name)
    return tuple(p.shape) if pl is None else pl.full_shape(p.shape)


def _mean(x: torch.Tensor, dim: int, whole_dim: int, pl, keepdim: bool = True) -> torch.Tensor:
    """``x.mean(dim)`` of the whole tensor: where ``whole_dim`` (the dim's
    index in the parameter) is split, the slices' sums are summed over the
    split's axis (every rank of it: a slice that several ranks hold counts
    as often) before dividing by the whole size as often."""
    axes = [] if pl is None else [axis for d, parts, axis in pl.splits
                                  if d == whole_dim and parts > 1]
    if not axes:
        return x.mean(dim=dim, keepdim=keepdim)
    total = x.sum(dim=dim, keepdim=keepdim)
    for axis in axes:
        total = pl.mesh.all_reduce(total, axis)
    return total / (x.shape[dim] * math.prod(pl.mesh.shape[a] for a in axes))


def stacked_leaf(name: str) -> str:
    """The JAX tree leaf a port parameter belongs to: every layer of a
    ``blocks.<i>`` / ``layers.<i>`` list is one stacked ``[L, ...]`` leaf."""
    return re.sub(r"\.(blocks|layers)\.\d+\.", r".\1.*.", name)


@dataclass
class AdafactorState:
    """optax's ``FactoredState``, keyed like the parameters: the update count,
    the row and column statistics of factored parameters and the whole
    second moment of the others (each dict holds only the parameters it
    applies to)."""

    count: int
    v_row: dict
    v_col: dict
    v: dict


def _factored_dims(shape, min_dim: int) -> Optional[tuple]:
    """optax's choice: the indices (second largest, largest) of the shape's
    two largest dimensions when the smaller of them is at least ``min_dim``."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: (shape[i], i))
    if shape[order[-2]] < min_dim:
        return None
    return order[-2], order[-1]


class Adafactor:
    # optax's defaults, which the JAX package keeps
    MIN_DIM_SIZE_TO_FACTOR = 128
    DECAY_RATE = 0.8
    CLIPPING_THRESHOLD = 1.0
    EPSILON = 1e-30

    def __init__(self, learning_rate: Union[float, Callable[[int], float]] = 1e-3,
                 weight_decay_rate: Optional[float] = None,
                 max_grad_norm: Optional[float] = None):
        self.learning_rate = learning_rate
        self.weight_decay_rate = weight_decay_rate
        self.max_grad_norm = max_grad_norm

    def init(self, params: dict, layouts: Optional[dict] = None) -> AdafactorState:
        """Zero statistics; ``layouts`` as in ``step`` (the factoring
        follows each parameter's whole shape)."""
        v_row, v_col, v = {}, {}, {}
        for name, p in params.items():
            pl = (layouts or {}).get(name)
            dims = _factored_dims(_whole(p, name, layouts), self.MIN_DIM_SIZE_TO_FACTOR)
            if dims is None:
                v[name] = set_placement(torch.zeros_like(p, requires_grad=False), pl)
            else:
                d1, d0 = dims
                v_row[name] = set_placement(torch.zeros_like(p.select(d0, 0), requires_grad=False),
                                            None if pl is None else pl.drop(d0))
                v_col[name] = set_placement(torch.zeros_like(p.select(d1, 0), requires_grad=False),
                                            None if pl is None else pl.drop(d1))
        return AdafactorState(count=0, v_row=v_row, v_col=v_col, v=v)

    def _update(self, name: str, p: torch.Tensor, g: torch.Tensor, state: AdafactorState,
                layouts: dict) -> torch.Tensor:
        """``g`` scaled by the (new) second-moment statistics."""
        pl = layouts.get(name)
        dims = _factored_dims(_whole(p, name, layouts), self.MIN_DIM_SIZE_TO_FACTOR)
        if dims is None:
            return g * state.v[name].rsqrt()
        d1, d0 = dims
        row = state.v_row[name]
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_mean = _mean(row, reduced_d1, d1, pl)
        row_factor = (row / row_mean).rsqrt()
        return g * row_factor.unsqueeze(d0) * state.v_col[name].rsqrt().unsqueeze(d1)

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: AdafactorState,
             layouts: Optional[dict] = None) -> AdafactorState:
        """Update ``params`` in place from ``grads`` and return the new state
        (its statistics updated in place). Two passes over the parameters:
        the first updates the statistics and sums each block's squared
        update, the second recomputes the update, clips it by its block's
        RMS and applies it. ``layouts`` as in ``Adam.step``."""
        layouts = layouts or {}
        clip = _global_norm_clip(grads, self.max_grad_norm, layouts)
        lr = self.learning_rate(state.count) if callable(self.learning_rate) else self.learning_rate
        t = torch.tensor(float(state.count + 1), dtype=torch.float32)
        decay = float(1.0 - t ** (-self.DECAY_RATE))

        def grad(name, p):
            g = grads[name].to(p.dtype)
            return g if clip is None else (g / clip.to(p.dtype)) * self.max_grad_norm

        sq_sum, size = {}, {}
        for name, p in params.items():
            g = grad(name, p)
            g2 = g.square() + self.EPSILON
            pl = layouts.get(name)
            dims = _factored_dims(_whole(p, name, layouts), self.MIN_DIM_SIZE_TO_FACTOR)
            if dims is None:
                state.v[name].mul_(decay).add_((1.0 - decay) * g2)
            else:
                d1, d0 = dims
                state.v_row[name].mul_(decay).add_((1.0 - decay) * _mean(g2, d0, d0, pl, False))
                state.v_col[name].mul_(decay).add_((1.0 - decay) * _mean(g2, d1, d1, pl, False))
            del g2
            block = stacked_leaf(name)
            u = self._update(name, p, g, state, layouts)
            sq_sum[block] = sq_sum.get(block, 0.0) + _sum_squares(u) * _weight(pl)
            size[block] = size.get(block, 0) + math.prod(_whole(p, name, layouts))
        if layouts:  # every block's sum over the mesh, in one call an axis
            names = list(sq_sum)
            sums = _mesh_sum(torch.stack([sq_sum[b] for b in names]), layouts)
            sq_sum = dict(zip(names, sums.unbind(0)))
        for name, p in params.items():
            u = self._update(name, p, grad(name, p), state, layouts)
            block = stacked_leaf(name)
            rms = torch.sqrt(sq_sum[block] / size[block]).float()
            u = u / torch.clamp(rms / self.CLIPPING_THRESHOLD, min=1.0).to(u.dtype)
            u = u * lr
            if self.weight_decay_rate is not None:
                u = u + self.weight_decay_rate * p
            p.sub_(u)
        return AdafactorState(count=state.count + 1, v_row=state.v_row, v_col=state.v_col,
                              v=state.v)
