"""Gradient accumulation shared by the LoRA and full fine-tuning steps
(counterpart of ``llama32mm_tpu/train/accum.py``).

The loss of a batch is a mean over its valid shifted targets, so the
accumulated gradient weights each microbatch's gradient by its valid-target
count: ``grad = sum_i n_i grad_i / sum_i n_i``, which equals the one big
batch's gradient exactly even when microbatches carry different padding. The
microbatches run one after another (the memory of one).

Under data parallelism each rank holds its rows of every microbatch, the
loss is the global token mean (``models/vlm.py``) and ``n_i`` is the
microbatch's valid-target count summed over ``dp``: each rank's result is
then its share of the one-device gradient, which the trainers sum over
``dp``. Under sequence parallelism the count is that of the rank's chunk's
targets shifted over the whole row (``models/vlm.py::shifted_targets``),
summed over ``dp`` and ``sp``. A rank whose rows of a microbatch are all padding is fine; a
microbatch that is all padding on every rank has weight 0.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from llama32mm_tpu_torch.models.vlm import shifted_targets
from llama32mm_tpu_torch.parallel.mesh import AXIS_DP, AXIS_SP


def valid_target_count(labels: torch.Tensor, ignore_index: int, mesh=None) -> torch.Tensor:
    """Number of positions the shifted CE scores: targets are ``labels[:, 1:]``
    (``shifted_targets``) minus ``ignore_index`` entries (fp32); with a
    ``mesh``, summed over its ``dp`` and ``sp`` ranks."""
    n = (shifted_targets(labels, ignore_index, mesh) != ignore_index).sum().to(torch.float32)
    if mesh is not None:
        for axis in (AXIS_DP, AXIS_SP):
            n = mesh.all_reduce(n, axis)
    return n


def loss_and_grads(loss: torch.Tensor, wrt: Sequence[torch.Tensor]):
    """``(loss, [d loss / d w])``; a tensor the loss does not reach gets
    zeros, as ``jax.grad`` gives."""
    grads = torch.autograd.grad(loss, list(wrt), allow_unused=True)
    return loss.detach(), [torch.zeros_like(w) if g is None else g for g, w in zip(grads, wrt)]


def accumulate_grads(loss_fn: Callable[[dict], torch.Tensor], wrt: Sequence[torch.Tensor],
                     batch: dict, accum_steps: int, ignore_index: int, mesh=None):
    """Run ``loss_fn(microbatch)`` over the leading ``[A, ...]`` axis of every
    ``batch`` entry and return ``(loss, grads)`` equal to one big-batch
    ``loss`` and gradient (on a ``mesh``: the global loss and this rank's
    share of the gradient)."""
    for key, value in batch.items():
        if value is not None and value.shape[0] != accum_steps:
            raise ValueError(f"accum_steps={accum_steps}: batch[{key!r}] must carry a leading "
                             f"microbatch axis of that size, got shape {tuple(value.shape)}")
    gsum, lsum, nsum = None, 0.0, 0.0
    for i in range(accum_steps):
        mb = {key: None if value is None else value[i] for key, value in batch.items()}
        loss, grads = loss_and_grads(loss_fn(mb), wrt)
        n = valid_target_count(mb["labels"], ignore_index, mesh).to(loss.device)
        scaled = [g * n for g in grads]
        gsum = scaled if gsum is None else [a + g for a, g in zip(gsum, scaled)]
        lsum, nsum = lsum + loss * n, nsum + n
    nsum = nsum.clamp(min=1)
    return lsum / nsum, [(g / nsum).to(g.dtype) for g in gsum]


def all_reduce_flat(tensors: Sequence[torch.Tensor], mesh, axis: str) -> None:
    """Sum each tensor over ``axis`` of ``mesh`` in place, in one collective
    per dtype (the tensors copied into one flat buffer and back); nothing
    on one rank."""
    if mesh is None or mesh.shape[axis] == 1 or not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = mesh.all_reduce(torch.cat([t.reshape(-1) for t in group]), axis)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view(t.shape))
