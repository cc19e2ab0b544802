"""Token sampling: greedy / temperature / top-k / top-p / min-p (counterpart
of ``llama32mm_tpu/utils/sampling.py``).

Temperature 0 is greedy argmax. Otherwise the logits are temperature-scaled,
then top-k (kth-value threshold), top-p (the reference's exclusive-of-
current-token cumulative rule: a token survives while ``cumsum - prob <=
top_p``) and min-p (a ratio test against the top token) mask them, in that
order, and a token is drawn with an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def filter_logits(
    logits: torch.Tensor,  # [..., V]
    temperature: float,
    top_p: float = 0.9,
    top_k: int = 50,
    min_p: float = 0.0,
) -> torch.Tensor:
    """Filtered fp32 logits, ``-inf`` on removed tokens. Needs temperature > 0."""
    logits = logits.float() / temperature
    neg_inf = float("-inf")

    if top_k > 0:
        k = min(top_k, logits.shape[-1])
        kth_val = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth_val, neg_inf, logits)

    if top_p < 1.0:
        sorted_logits, order = torch.sort(logits, dim=-1, descending=True, stable=True)
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        drop = (cum - probs) > top_p  # exclusive of the current token
        sorted_logits = torch.where(drop, neg_inf, sorted_logits)
        logits = torch.empty_like(logits).scatter_(-1, order, sorted_logits)

    if min_p > 0.0:
        lmax = logits.amax(dim=-1, keepdim=True)
        logits = torch.where(logits < lmax + math.log(min_p), neg_inf, logits)

    return logits


def select_next_token(
    logits: torch.Tensor,  # [..., V]
    rng: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_p: float = 0.9,
    top_k: int = 50,
    min_p: float = 0.0,
) -> torch.Tensor:
    """Token ids ``[...]``: argmax at temperature 0, else a draw from the
    filtered distribution with ``rng``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature, top_p, top_k, min_p), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=rng).reshape(probs.shape[:-1])
