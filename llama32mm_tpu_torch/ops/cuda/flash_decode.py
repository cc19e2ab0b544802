"""Split-KV flash decode: the CUDA kernels (``csrc/flash_decode.cu``) and
their plain PyTorch version, for calls with few query rows per kv head
(``Tq * G <= DECODE_MAX_ROWS``, G = nq / nkv): decode steps, the server's
decode over slots at their own fill levels, tiny prefills. The function is
the flash forward's (``ops/cuda/attention.py``): the structured mask with
one ``q_offset`` or one per batch row, mask-then-scale logits, blocked keys
at probability exactly 0, a row with no allowed key 0; K/V in q's float
dtype, or int8 with per-position fp32 scales. No log-sum-exp: inference
only.

The keys are cut into splits of ``KV_SPLIT`` keys at fixed absolute
positions (``[s * KV_SPLIT, (s + 1) * KV_SPLIT)``). Each split yields, per
query row, a partial ``(m, l, acc)``: the max of its allowed logits (-inf if
none), the sum of ``exp(logit - m)`` and the sum of those weights times v
(times ``v_scale`` with an int8 cache). The partials merge in split order:
``M = max m_s``, ``L = sum l_s e^(m_s - M)``, ``O = sum acc_s e^(m_s - M) /
L`` (0 where ``L = 0``). Because the boundaries depend on nothing but
``KV_SPLIT``, a row's result is the same, bit for bit, whatever the batch it
sits in and whatever invalid keys follow its own: an empty split adds exact
zeros.
"""

from __future__ import annotations

import math

import torch

from llama32mm_tpu_torch.ops.cuda.attention import _check, _q_offsets, allowed_mask
from llama32mm_tpu_torch.ops.cuda.build import check, load_library
from llama32mm_tpu_torch.ops.cuda.common import acc_dtype, counted, dtype_code, stream_of

KV_SPLIT = 64  # keys per split; the kernel's kSplit
DECODE_MAX_ROWS = 32  # query rows per kv head (Tq * G) that one decode block serves


def _launch(q, k, v, kv_valid, q_offset, causal, k_scale=None, v_scale=None):
    kvv, shape = _check(q, k, v, kv_valid, k_scale, v_scale)
    b, nq, nkv, tq, tk, hd = shape
    if tq * (nq // nkv) > DECODE_MAX_ROWS:
        raise ValueError(f"flash decode serves Tq * G <= {DECODE_MAX_ROWS} rows per kv head, "
                         f"got Tq={tq}, G={nq // nkv}")
    scalar, offsets = _q_offsets(q_offset, q)
    n_split = -(-tk // KV_SPLIT)
    # per (row, split): m, l, then acc[hd]; all fp32
    ws = torch.empty(b * nq * tq * n_split * (hd + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    status = load_library().l32_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        kvv.data_ptr(), None if offsets is None else offsets.data_ptr(), ws.data_ptr(),
        out.data_ptr(), *shape, scalar, int(bool(causal)), dtype_code(q), stream_of(q))
    check(status, "flash decode kernel")
    return out


@counted("launches")
def flash_decode_cuda(
    q: torch.Tensor,  # [B, nq, Tq, hd] fp32 or bf16, Tq * G <= DECODE_MAX_ROWS
    k: torch.Tensor,  # [B, nkv, Tk, hd] q's dtype
    v: torch.Tensor,
    kv_valid: torch.Tensor,  # [B, Tk] bool/int
    q_offset,  # int, or int [B] on q's device
    causal: bool = True,
) -> torch.Tensor:
    out = _launch(q, k, v, kv_valid, q_offset, causal)
    flash_decode_cuda.launches += 1
    return out


@counted("launches")
def flash_decode_int8kv_cuda(
    q: torch.Tensor,  # [B, nq, Tq, hd] fp32 or bf16
    k: torch.Tensor,  # [B, nkv, Tk, hd] int8
    v: torch.Tensor,
    k_scale: torch.Tensor,  # [B, nkv, Tk] fp32
    v_scale: torch.Tensor,
    kv_valid: torch.Tensor,
    q_offset,
    causal: bool = True,
) -> torch.Tensor:
    out = _launch(q, k, v, kv_valid, q_offset, causal, k_scale, v_scale)
    flash_decode_int8kv_cuda.launches += 1
    return out


@counted("calls")
def flash_decode_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: torch.Tensor, q_offset,
    causal: bool = True, split: int = KV_SPLIT,
) -> torch.Tensor:
    """The kernels' split-KV algorithm with dense fp32 partials."""
    flash_decode_plain.calls += 1
    return _split_kv(q, k, v, kv_valid, q_offset, causal, None, None, split)


@counted("calls")
def flash_decode_int8kv_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_scale: torch.Tensor,
    v_scale: torch.Tensor, kv_valid: torch.Tensor, q_offset, causal: bool = True,
    split: int = KV_SPLIT,
) -> torch.Tensor:
    """The int8-KV split-KV algorithm with dense fp32 partials."""
    flash_decode_int8kv_plain.calls += 1
    return _split_kv(q, k, v, kv_valid, q_offset, causal, k_scale, v_scale, split)


def _finite(m):
    """``m`` with -inf (a row or split with no allowed key) replaced by 0."""
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def _split_kv(q, k, v, kv_valid, q_offset, causal, k_scale, v_scale, split):
    b, nq, tq, hd = q.shape
    nkv, tk = k.shape[1], k.shape[2]
    g, acc = nq // nkv, acc_dtype(q)
    n_split = -(-tk // split)
    pad = n_split * split - tk

    def by_split(t):  # [B, nkv, Tk, ...] -> [B, nkv, n_split, split, ...], zero-padded
        t = t.to(acc)
        if pad:
            t = torch.cat([t, t.new_zeros(*t.shape[:2], pad, *t.shape[3:])], dim=2)
        return t.reshape(*t.shape[:2], n_split, split, *t.shape[3:])

    allowed = allowed_mask(kv_valid, q_offset, causal, tq, tk, q.device)
    allowed = allowed.expand(b, 1, g, tq, tk).reshape(b, 1, g * tq, tk)  # rows r = g_i * Tq + i
    if pad:
        allowed = torch.cat([allowed, allowed.new_zeros(b, 1, g * tq, pad)], dim=-1)
    allowed = allowed.reshape(b, 1, g * tq, n_split, split).transpose(2, 3)  # [B,1,S,R,split]

    qg = q.to(acc).reshape(b, nkv, 1, g * tq, hd)
    scores = torch.matmul(qg, by_split(k).transpose(-1, -2))  # [B, nkv, S, R, split]
    if k_scale is not None:
        scores = scores * by_split(k_scale)[:, :, :, None, :]
    logits = torch.where(allowed, scores * (1.0 / math.sqrt(hd)), float("-inf"))
    m = logits.amax(dim=-1)  # [B, nkv, S, R], -inf for a split with no allowed key
    p = torch.exp(logits - _finite(m)[..., None])
    l = p.sum(dim=-1)
    if v_scale is not None:  # re-masked: blocked slots' scales never reach the sum
        p = torch.where(allowed, p * by_split(v_scale)[:, :, :, None, :], 0.0)
    part = torch.matmul(p, by_split(v))  # [B, nkv, S, R, hd]

    big_m = _finite(m.amax(dim=2, keepdim=True))  # [B, nkv, 1, R]
    w = torch.where(torch.isfinite(m), torch.exp(m - big_m), 0.0)  # an empty split weighs 0
    big_l = torch.zeros_like(l[:, :, 0])
    o = torch.zeros_like(part[:, :, 0])
    for s in range(n_split):  # in split order
        big_l = big_l + l[:, :, s] * w[:, :, s]
        o = o + part[:, :, s] * w[:, :, s, :, None]
    o = torch.where(big_l[..., None] > 0, o / torch.where(big_l > 0, big_l, 1.0)[..., None], 0.0)
    return o.reshape(b, nq, tq, hd).to(q.dtype)
