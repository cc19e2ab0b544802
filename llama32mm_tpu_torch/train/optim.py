"""Adam and AdamW with optax's update rules, optionally after
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

Parameters are updated in place, one at a time, so the temporaries of a step
are those of the largest parameter rather than of the whole model.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch


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

    def init(self, params: dict) -> AdamState:
        zeros = {name: torch.zeros_like(p, requires_grad=False) for name, p in params.items()}
        return AdamState(count=0, mu=zeros,
                         nu={name: torch.zeros_like(p, requires_grad=False)
                             for name, p in params.items()})

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: AdamState) -> AdamState:
        """Update ``params`` in place from ``grads`` (same keys; a gradient
        may be of a lower precision than its parameter) and return the new
        state (its moments are updated in place)."""
        clip = None
        if self.max_grad_norm is not None:
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
            if not bool(norm < self.max_grad_norm):
                clip = norm
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
