"""Flash GQA attention forward: the CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version, replacing
``llama32mm_tpu/ops/pallas/attention.py::_flash_kernel``: K/V in q's float
dtype (``flash_attention_*``), or int8 with per-position fp32 scales
(``flash_attention_int8kv_*``, the kernel's ``scaled_kv`` inputs).

Mask: key ``k`` is allowed for query row ``i`` iff ``kv_valid[b, k] != 0``
and, when causal, ``k <= q_offset + i``. Allowed logits are ``s / sqrt(hd)``
(mask-then-scale), blocked keys get probability exactly 0, and a row with
no allowed key is 0. With an int8 cache, ``s = (q·k_q)·k_scale[key]``
before the mask, and the value scale multiplies each probability in the PV
product but not the softmax denominator.
"""

from __future__ import annotations

import math

import torch

from llama32mm_tpu_torch.ops.cuda.build import check, load_library
from llama32mm_tpu_torch.ops.cuda.common import counted, dtype_code, require, stream_of

HEAD_DIMS = (8, 16, 32, 64, 80, 96, 128)


def _launch(q, k, v, kv_valid, q_offset, causal, k_scale=None, v_scale=None) -> torch.Tensor:
    """Check the operands and launch the float or the int8-KV kernel."""
    require("q", q, q)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q and k must be [B, heads, T, hd]")
    b, nq, tq, hd = q.shape
    nkv, tk = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported by the kernel; supported: {HEAD_DIMS}")
    if nkv == 0 or nq % nkv != 0:
        raise ValueError(f"n_heads {nq} must be a multiple of n_kv_heads {nkv}")
    kv_dtype = q.dtype if k_scale is None else torch.int8
    require("k", k, q, (b, nkv, tk, hd), kv_dtype)
    require("v", v, q, (b, nkv, tk, hd), kv_dtype)
    if tuple(kv_valid.shape) != (b, tk) or kv_valid.device != q.device:
        raise ValueError(f"kv_valid must be [{b}, {tk}] on {q.device}")
    kvv = kv_valid.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = load_library()
    common = (b, nq, nkv, tq, tk, hd, int(q_offset), int(bool(causal)), dtype_code(q), stream_of(q))
    if k_scale is None:
        status = lib.l32_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kvv.data_ptr(), out.data_ptr(), *common)
    else:
        require("k_scale", k_scale, q, (b, nkv, tk), torch.float32)
        require("v_scale", v_scale, q, (b, nkv, tk), torch.float32)
        status = lib.l32_flash_attn_fwd_int8kv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            kvv.data_ptr(), out.data_ptr(), *common)
    check(status, "flash attention kernel")
    return out


@counted("launches")
def flash_attention_cuda(
    q: torch.Tensor,  # [B, nq, Tq, hd]
    k: torch.Tensor,  # [B, nkv, Tk, hd]
    v: torch.Tensor,  # [B, nkv, Tk, hd]
    kv_valid: torch.Tensor,  # [B, Tk] bool/int
    q_offset: int,
    causal: bool = True,
) -> torch.Tensor:
    out = _launch(q, k, v, kv_valid, q_offset, causal)
    flash_attention_cuda.launches += 1
    return out


@counted("calls")
def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: torch.Tensor,
    q_offset: int, causal: bool = True,
) -> torch.Tensor:
    """The kernel's function with dense fp32 scores."""
    flash_attention_plain.calls += 1
    return _dense(q, k, v, kv_valid, q_offset, causal)


@counted("launches")
def flash_attention_int8kv_cuda(
    q: torch.Tensor,  # [B, nq, Tq, hd] float
    k: torch.Tensor,  # [B, nkv, Tk, hd] int8
    v: torch.Tensor,  # [B, nkv, Tk, hd] int8
    k_scale: torch.Tensor,  # [B, nkv, Tk] fp32
    v_scale: torch.Tensor,  # [B, nkv, Tk] fp32
    kv_valid: torch.Tensor,  # [B, Tk] bool/int
    q_offset: int,
    causal: bool = True,
) -> torch.Tensor:
    out = _launch(q, k, v, kv_valid, q_offset, causal, k_scale, v_scale)
    flash_attention_int8kv_cuda.launches += 1
    return out


@counted("calls")
def flash_attention_int8kv_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_scale: torch.Tensor,
    v_scale: torch.Tensor, kv_valid: torch.Tensor, q_offset: int, causal: bool = True,
) -> torch.Tensor:
    """The int8-KV kernel's function with dense fp32 scores."""
    flash_attention_int8kv_plain.calls += 1
    return _dense(q, k, v, kv_valid, q_offset, causal, k_scale, v_scale)


def _dense(q, k, v, kv_valid, q_offset, causal, k_scale=None, v_scale=None) -> torch.Tensor:
    b, nq, tq, hd = q.shape
    nkv, tk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, nkv, nq // nkv, tq, hd)
    scores = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float())
    if k_scale is not None:
        scores = scores * k_scale.float()[:, :, None, None, :]
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
    if v_scale is not None:  # re-masked: blocked slots' scales never reach the sum
        p = torch.where(allowed, p * v_scale.float()[:, :, None, None, :], 0.0)
    ctx = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    return ctx.reshape(b, nq, tq, hd).to(q.dtype)
