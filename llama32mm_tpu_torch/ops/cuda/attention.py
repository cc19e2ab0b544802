"""Flash GQA attention forward: the CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version, replacing
``llama32mm_tpu/ops/pallas/attention.py::_flash_kernel`` (float path).

Mask: key ``k`` is allowed for query row ``i`` iff ``kv_valid[b, k] != 0``
and, when causal, ``k <= q_offset + i``. Allowed logits are ``s / sqrt(hd)``
(mask-then-scale), blocked keys get probability exactly 0, and a row with
no allowed key is 0.
"""

from __future__ import annotations

import math

import torch

from llama32mm_tpu_torch.ops.cuda.build import check, load_library
from llama32mm_tpu_torch.ops.cuda.common import counted, dtype_code, require, stream_of

HEAD_DIMS = (8, 16, 32, 64, 80, 96, 128)


@counted("launches")
def flash_attention_cuda(
    q: torch.Tensor,  # [B, nq, Tq, hd]
    k: torch.Tensor,  # [B, nkv, Tk, hd]
    v: torch.Tensor,  # [B, nkv, Tk, hd]
    kv_valid: torch.Tensor,  # [B, Tk] bool/int
    q_offset: int,
    causal: bool = True,
) -> torch.Tensor:
    require("q", q, q)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q and k must be [B, heads, T, hd]")
    b, nq, tq, hd = q.shape
    nkv, tk = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported by the kernel; supported: {HEAD_DIMS}")
    if nkv == 0 or nq % nkv != 0:
        raise ValueError(f"n_heads {nq} must be a multiple of n_kv_heads {nkv}")
    require("k", k, q, (b, nkv, tk, hd))
    require("v", v, q, (b, nkv, tk, hd))
    if tuple(kv_valid.shape) != (b, tk) or kv_valid.device != q.device:
        raise ValueError(f"kv_valid must be [{b}, {tk}] on {q.device}")
    kvv = kv_valid.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    status = load_library().l32_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kvv.data_ptr(), out.data_ptr(),
        b, nq, nkv, tq, tk, hd, int(q_offset), int(bool(causal)), dtype_code(q), stream_of(q),
    )
    check(status, "flash attention kernel")
    flash_attention_cuda.launches += 1
    return out


@counted("calls")
def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: torch.Tensor,
    q_offset: int, causal: bool = True,
) -> torch.Tensor:
    """The kernel's function with dense fp32 scores."""
    flash_attention_plain.calls += 1
    b, nq, tq, hd = q.shape
    nkv, tk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, nkv, nq // nkv, tq, hd)
    scores = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float())
    allowed = kv_valid.bool()[:, None, None, None, :]  # [B, 1, 1, 1, Tk]
    if causal:
        kpos = torch.arange(tk, device=q.device)
        qpos = int(q_offset) + torch.arange(tq, device=q.device)
        allowed = allowed & (kpos[None, :] <= qpos[:, None])
    logits = torch.where(allowed, scores * (1.0 / math.sqrt(hd)), float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom > 0, denom, torch.ones_like(denom))
    ctx = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    return ctx.reshape(b, nq, tq, hd).to(q.dtype)
