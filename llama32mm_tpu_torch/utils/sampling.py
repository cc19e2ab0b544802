"""Token sampling: greedy / temperature / top-k / top-p / min-p /
repetition penalty (counterpart of ``llama32mm_tpu/utils/sampling.py``).

Temperature 0 is greedy argmax. Otherwise the logits are temperature-scaled,
then top-k (kth-value threshold), top-p (the reference's exclusive-of-
current-token cumulative rule: a token survives while ``cumsum - prob <=
top_p``) and min-p (a ratio test against the top token) mask them, in that
order, and a token is drawn with an explicit ``torch.Generator``. The CTRL
repetition penalty applies before the greedy/sampled split.

The ``*_traced`` functions take per-row settings as ``[B]`` tensors (the
server's slots each carry their request's sampler), in the JAX package's
order and arithmetic. A sampled row draws by the Gumbel-max rule, the
argmax of ``logits - log(-log(u))`` for uniforms ``u`` (``jax.random.
categorical``'s rule); the uniforms come from a ``torch.Generator``, or are
given (the tests hand both packages the same ones). Where the JAX package
decides its fast paths on the device (``lax.cond`` over "every row greedy",
"no row penalised"), the caller decides them from its host copy of the
settings, so a step never reads a device value.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def apply_repetition_penalty(logits: torch.Tensor, presence: torch.Tensor,
                             penalty) -> torch.Tensor:
    """CTRL penalty: where ``presence`` (the token is in the row's context),
    positive logits are divided by ``penalty`` and negative ones multiplied.
    ``penalty`` is a float or a ``[...]`` tensor (one per row). fp32 out."""
    logits = logits.float()
    pen = penalty if isinstance(penalty, torch.Tensor) else torch.tensor(float(penalty))
    pen = pen.to(device=logits.device, dtype=torch.float32)
    pen = pen.reshape(pen.shape + (1,) * (logits.dim() - pen.dim()))
    return torch.where(presence, torch.where(logits > 0, logits / pen, logits * pen), logits)


def presence_from_tokens(tokens: torch.Tensor, n_valid: torch.Tensor,
                         vocab_size: int) -> torch.Tensor:
    """``[B, S]`` token history (rows right-padded; ``n_valid [B]`` leading
    entries count) → ``[B, vocab]`` bool presence. Entries past ``n_valid``
    and ids outside the vocabulary (the image placeholder) are ignored."""
    b, s = tokens.shape
    valid = ((torch.arange(s, device=tokens.device)[None, :] < n_valid[:, None])
             & (tokens >= 0) & (tokens < vocab_size))
    idx = torch.where(valid, tokens.long(), vocab_size)  # column `vocab_size` takes the rest
    pres = torch.zeros(b, vocab_size + 1, dtype=torch.bool, device=tokens.device)
    return pres.scatter_(1, idx, True)[:, :vocab_size]


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
    presence: Optional[torch.Tensor] = None,  # [..., V] bool
    repetition_penalty: float = 1.0,
) -> torch.Tensor:
    """Token ids ``[...]``: argmax at temperature 0, else a draw from the
    filtered distribution with ``rng``; the repetition penalty (with a
    ``presence`` mask) reshapes the logits first, greedy rows too."""
    if repetition_penalty != 1.0 and presence is not None:
        logits = apply_repetition_penalty(logits, presence, repetition_penalty)
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature, top_p, top_k, min_p), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=rng).reshape(probs.shape[:-1])


def filter_logits_traced(
    logits: torch.Tensor,  # [B, V]
    temperature: torch.Tensor,  # [B] float
    top_p: torch.Tensor,  # [B] float
    top_k: torch.Tensor,  # [B] int
    min_p: Optional[torch.Tensor] = None,  # [B] float, 0 = off
) -> torch.Tensor:
    """``filter_logits`` with per-row settings: ``top_k <= 0`` and
    ``top_p >= 1`` disable those masks, a row with ``temperature <= 0``
    divides by 1e-6 (its caller takes the argmax instead)."""
    v = logits.shape[-1]
    neg_inf = float("-inf")
    t = temperature.float().clamp(min=1e-6)[:, None]
    logits = logits.float() / t

    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k = top_k.long().clamp(1, v)
    kth_val = torch.gather(sorted_desc, 1, (k - 1)[:, None])
    logits = torch.where((top_k > 0)[:, None] & (logits < kth_val), neg_inf, logits)

    # top-p over the k-masked logits; the order of ties is the JAX package's
    # (a stable ascending argsort, reversed)
    order = torch.flip(torch.argsort(logits, dim=-1, stable=True), dims=(-1,))
    sorted2 = torch.gather(logits, 1, order)
    probs = torch.softmax(sorted2, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    drop = ((cum - probs) > top_p[:, None]) & (top_p < 1.0)[:, None]
    sorted2 = torch.where(drop, neg_inf, sorted2)
    logits = torch.empty_like(logits).scatter_(1, order, sorted2)

    if min_p is not None:  # last, as the HF warpers
        lmax = logits.amax(dim=-1, keepdim=True)
        thresh = lmax + torch.log(min_p.float().clamp(min=1e-30))[:, None]
        logits = torch.where((min_p > 0.0)[:, None] & (logits < thresh), neg_inf, logits)
    return logits


def gumbel_argmax(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                  uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A categorical draw per row: ``argmax(logits - log(-log(u)))``, ``u``
    uniform in ``[tiny, 1)`` (given, or drawn from ``generator``)."""
    if uniforms is None:
        uniforms = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = uniforms.float().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def select_next_token_traced(
    logits: torch.Tensor,  # [B, V]
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B]
    min_p: Optional[torch.Tensor] = None,  # [B]
    presence: Optional[torch.Tensor] = None,  # [B, V] bool
    penalty: Optional[torch.Tensor] = None,  # [B], 1.0 = off
    all_greedy: bool = False,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,  # [B, V]
) -> torch.Tensor:
    """Per-row sampling: rows with ``temperature <= 0`` take the argmax, the
    rest draw from their filtered distribution. The penalty (given with
    ``presence``) applies first. ``all_greedy`` (the caller's host-side
    knowledge that every row is greedy) skips the filter's full-vocabulary
    sort, as the JAX package's ``lax.cond``; pass ``presence``/``penalty``
    only when some row is penalised."""
    if presence is not None and penalty is not None:
        logits = apply_repetition_penalty(logits, presence, penalty)
    greedy = torch.argmax(logits, dim=-1)
    if all_greedy:
        return greedy
    filt = filter_logits_traced(logits, temperature, top_p, top_k, min_p)
    sampled = gumbel_argmax(filt, generator, uniforms)
    return torch.where(temperature <= 0.0, greedy, sampled)


def spec_verify_tokens(
    logits: torch.Tensor,  # [B, K+1, V] target logits at each fed position
    drafts: torch.Tensor,  # [B, K] proposed (deterministic) draft tokens
    generator: Optional[torch.Generator],
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B]
    min_p: Optional[torch.Tensor] = None,  # [B]
    presence: Optional[torch.Tensor] = None,  # [B, V] bool context presence at chunk start
    penalty: Optional[torch.Tensor] = None,  # [B], 1.0 = off
    all_greedy: bool = False,
    rows: Optional[tuple] = None,
) -> tuple:
    """Rejection-sampling verification of deterministic drafts. Returns
    ``(nxt [B, K+1] long, acc [B, K] bool)``: the caller commits ``nxt[:,
    :n]``, ``n - 1`` the length of ``acc``'s leading-True run, i.e. the
    accepted drafts, then the replacement at the first miss, or the bonus
    token at position K when every draft was accepted.

    A draft is a point mass, so the rejection rule is: accept draft ``d``
    with probability ``p(d)`` under the row's filtered distribution ``p``
    (``filter_logits_traced``'s); on the first miss draw from ``p`` with
    ``d`` removed. Every committed token is then distributed as ``p``.
    Greedy rows (``temperature <= 0``) accept iff the draft is the argmax
    and commit the argmax. ``all_greedy`` (the caller's host-side knowledge)
    skips the full-vocabulary filter, as the JAX package's ``lax.cond``.
    A draft outside the vocabulary is never accepted.

    The penalty (given with ``presence``) composes exactly: position ``j``
    is consulted only when drafts ``0..j-1`` were accepted, so its context
    is ``presence`` plus exactly those drafts, a cumulative one-hot.

    The draws cannot reproduce the JAX package's bits: they come from the
    one ``generator`` in a fixed order, the acceptance uniforms ``[B, K]``,
    then the replacements' ``[B, K, V]`` and the bonus tokens' ``[B, V]``
    (both by the Gumbel-max rule). ``rows``: ``(start, total)`` of these
    rows in a pool of ``total`` (a data-parallel server group's slots), the
    draws made for the whole pool and this group's rows taken, so that the
    pool draws as on one device."""
    b, k1, v = logits.shape
    k = k1 - 1
    dev = logits.device
    penalised = presence is not None and penalty is not None
    draft_hot = None  # [B, K, V]; all False for a draft off the vocabulary
    if penalised or not all_greedy:
        draft_hot = drafts[..., None] == torch.arange(v, device=dev)
    if penalised:
        cum = torch.cumsum(draft_hot.to(torch.int32), dim=1) > 0
        pres = torch.cat([presence[:, None], presence[:, None] | cum], dim=1)  # [B, K+1, V]
        logits = apply_repetition_penalty(logits, pres, penalty)
    greedy = torch.argmax(logits, dim=-1)  # [B, K+1]
    acc_greedy = drafts == greedy[:, :k]
    if all_greedy:
        return greedy, acc_greedy

    filt = filter_logits_traced(
        logits.reshape(b * k1, v), temperature.repeat_interleave(k1), top_p.repeat_interleave(k1),
        top_k.repeat_interleave(k1), None if min_p is None else min_p.repeat_interleave(k1),
    ).reshape(b, k1, v)
    p = torch.softmax(filt, dim=-1)
    in_vocab = (drafts >= 0) & (drafts < v)
    p_draft = torch.gather(p[:, :k], 2, drafts.clamp(0, v - 1)[..., None])[..., 0]
    p_draft = p_draft.masked_fill(~in_vocab, 0.0)
    start, total = (0, b) if rows is None else rows
    u_acc = torch.rand(total, k, generator=generator, device=dev)[start:start + b]
    u_repl = torch.rand(total, k, v, generator=generator, device=dev)[start:start + b]
    u_bonus = torch.rand(total, v, generator=generator, device=dev)[start:start + b]
    accept = u_acc < p_draft
    repl = gumbel_argmax(filt[:, :k].masked_fill(draft_hot, float("-inf")), uniforms=u_repl)
    bonus = gumbel_argmax(filt[:, k], uniforms=u_bonus)
    nxt = torch.cat([torch.where(accept, drafts, repl), bonus[:, None]], dim=1)
    g_row = (temperature <= 0.0)[:, None]
    return torch.where(g_row, greedy, nxt), torch.where(g_row, acc_greedy, accept)
