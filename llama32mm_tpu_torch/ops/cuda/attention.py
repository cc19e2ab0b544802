"""Flash GQA attention forward: the CUDA kernels and their plain PyTorch
version, replacing ``llama32mm_tpu/ops/pallas/attention.py::_flash_kernel``:
K/V in q's float dtype (``flash_attention_*``), or int8 with per-position
fp32 scales (``*_int8kv_*``, the kernel's ``scaled_kv`` inputs). Two
forwards compute the same function: the fp32-precision one on tensor cores
(``csrc/flash_attention_tf32.cu``, every fp32 product as three TF32
products; fp32 and bf16 q) and the bf16 one (``csrc/flash_attention_tc.cu``,
``flash_attention_tc*``, bf16 q only); ``ops/attention.py`` routes between
them and the split-KV decode kernel (``flash_decode.py``).

Mask: key ``k`` is allowed for query row ``i`` of batch row ``b`` iff
``kv_valid[b, k] != 0`` and, when causal, ``k <= q_offset + i``. The forward
takes ``q_offset`` as one int or, for a batch whose rows sit at different
fill levels (the continuous-batching server's slots), an int ``[B]`` tensor
on q's device: row ``b``'s limit is then ``q_offset[b] + i``. Allowed logits are ``s / sqrt(hd)``
(mask-then-scale), blocked keys get probability exactly 0, and a row with
no allowed key is 0. With an int8 cache, ``s = (q·k_q)·k_scale[key]``
before the mask, and the value scale multiplies each probability in the PV
product but not the softmax denominator.

Training (float K/V only): the forward also returns ``lse [B, nq, Tq]``
fp32, each row's log-sum-exp of the allowed logits (``_NEG_BIG`` for a row
with none), as the Pallas kernel's ``emit_lse`` output; the backward is two
kernels replacing ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``:
with ``p = exp(s / sqrt(hd) - lse)`` on allowed keys,
``ds = p (dO · v - delta) / sqrt(hd)`` and ``delta = rowsum(dO * O)``,
``dq = ds k``, ``dk = ds^T q`` and ``dv = p^T dO``, dk and dv summed over
each kv head's group of q heads. The fp32 pair (``flash_attention_bwd_*``)
keeps p and ds in fp32, both kernels on 3xTF32 tensor cores
(``csrc/flash_attention_tf32.cu``); the bf16 pair
(``flash_attention_bwd_*_tc``, ``csrc/flash_attention_bwd_tc.cu``) rounds p
and ds to bf16 before the products, as the Pallas kernels round them to q's
dtype.
"""

from __future__ import annotations

import math

import torch

from llama32mm_tpu_torch.ops.cuda.build import check, load_library
from llama32mm_tpu_torch.ops.cuda.common import acc_dtype, counted, dtype_code, require, stream_of

HEAD_DIMS = (8, 16, 32, 64, 80, 96, 128)
NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)  # lse of a row with no allowed key


def _check(q, k, v, kv_valid, k_scale=None, v_scale=None):
    """Check the operands (K/V in q's dtype, or int8 with fp32 scales
    ``[B, nkv, Tk]``); return ``(kv_valid as int32, the shape arguments)``."""
    kv_dtype = q.dtype if k_scale is None else torch.int8
    require("q", q, q)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q and k must be [B, heads, T, hd]")
    b, nq, tq, hd = q.shape
    nkv, tk = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported by the kernel; supported: {HEAD_DIMS}")
    if nkv == 0 or nq % nkv != 0:
        raise ValueError(f"n_heads {nq} must be a multiple of n_kv_heads {nkv}")
    require("k", k, q, (b, nkv, tk, hd), kv_dtype)
    require("v", v, q, (b, nkv, tk, hd), kv_dtype)
    if k_scale is not None:
        require("k_scale", k_scale, q, (b, nkv, tk), torch.float32)
        require("v_scale", v_scale, q, (b, nkv, tk), torch.float32)
    if tuple(kv_valid.shape) != (b, tk) or kv_valid.device != q.device:
        raise ValueError(f"kv_valid must be [{b}, {tk}] on {q.device}")
    return kv_valid.to(torch.int32).contiguous(), (b, nq, nkv, tq, tk, hd)


def _q_offsets(q_offset, q):
    """``(scalar offset, int32 [B] offsets or None)`` for the kernel."""
    if not isinstance(q_offset, torch.Tensor):
        return int(q_offset), None
    offsets = q_offset.to(torch.int32).contiguous()
    require("q_offset", offsets, q, (q.shape[0],), torch.int32)
    return 0, offsets


def _aligned16(*tensors):
    """The tensors, each copied to fresh storage if its data does not start
    on 16 bytes (the 3xTF32 kernels stage tiles by 16-byte copies)."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors)


def _launch(q, k, v, kv_valid, q_offset, causal, k_scale=None, v_scale=None, lse=False):
    """Launch the 3xTF32 forward (``csrc/flash_attention_tf32.cu``): float
    K/V (with ``lse``: also the log-sum-exp) or int8 K/V with scales."""
    kvv, shape = _check(q, k, v, kv_valid, k_scale, v_scale)
    scalar, offsets = _q_offsets(q_offset, q)
    offsets_ptr = None if offsets is None else offsets.data_ptr()
    q, k, v = _aligned16(q, k, v)
    out = torch.empty_like(q)
    lse_out = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if lse else None
    lib = load_library()
    common = (*shape, scalar, int(bool(causal)), dtype_code(q), stream_of(q))
    if k_scale is None:
        status = lib.l32_flash_attn_tf32_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kvv.data_ptr(), offsets_ptr, out.data_ptr(),
            None if lse_out is None else lse_out.data_ptr(), *common)
    else:
        status = lib.l32_flash_attn_tf32_fwd_int8kv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            kvv.data_ptr(), offsets_ptr, out.data_ptr(), *common)
    check(status, "3xTF32 flash attention kernel")
    return (out, lse_out) if lse else out


@counted("launches")
def flash_attention_cuda(
    q: torch.Tensor,  # [B, nq, Tq, hd]
    k: torch.Tensor,  # [B, nkv, Tk, hd]
    v: torch.Tensor,  # [B, nkv, Tk, hd]
    kv_valid: torch.Tensor,  # [B, Tk] bool/int
    q_offset,  # int, or int [B] on q's device
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
    q_offset,  # int, or int [B] on q's device
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


@counted("launches")
def flash_attention_fwd_lse_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: torch.Tensor,
    q_offset: int, causal: bool = True,
):
    """The training forward: ``(out, lse)``, lse ``[B, nq, Tq]`` fp32."""
    res = _launch(q, k, v, kv_valid, q_offset, causal, lse=True)
    flash_attention_fwd_lse_cuda.launches += 1
    return res


@counted("calls")
def flash_attention_fwd_lse_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: torch.Tensor,
    q_offset: int, causal: bool = True,
):
    """``(out, lse)`` with dense scores."""
    flash_attention_fwd_lse_plain.calls += 1
    return _dense(q, k, v, kv_valid, q_offset, causal, lse=True)


def _launch_tc(q, k, v, kv_valid, q_offset, causal, k_scale=None, v_scale=None, lse=False):
    """Launch the tensor-core forward (``csrc/flash_attention_tc.cu``): bf16
    q, K/V bf16 or int8 with scales, optionally the log-sum-exp."""
    kvv, shape = _check(q, k, v, kv_valid, k_scale, v_scale)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core flash forward takes bfloat16 q, got {q.dtype}")
    scalar, offsets = _q_offsets(q_offset, q)
    out = torch.empty_like(q)
    lse_out = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if lse else None
    status = load_library().l32_flash_attn_tc(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        kvv.data_ptr(), None if offsets is None else offsets.data_ptr(), out.data_ptr(),
        None if lse_out is None else lse_out.data_ptr(), *shape, scalar, int(bool(causal)),
        stream_of(q))
    check(status, "tensor-core flash attention kernel")
    return (out, lse_out) if lse else out


@counted("launches")
def flash_attention_tc_cuda(
    q: torch.Tensor,  # [B, nq, Tq, hd] bf16
    k: torch.Tensor,  # [B, nkv, Tk, hd] bf16
    v: torch.Tensor,
    kv_valid: torch.Tensor,  # [B, Tk] bool/int
    q_offset,  # int, or int [B] on q's device
    causal: bool = True,
) -> torch.Tensor:
    out = _launch_tc(q, k, v, kv_valid, q_offset, causal)
    flash_attention_tc_cuda.launches += 1
    return out


@counted("calls")
def flash_attention_tc_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: torch.Tensor, q_offset,
    causal: bool = True,
) -> torch.Tensor:
    """The tensor-core kernel's function with dense fp32 scores."""
    flash_attention_tc_plain.calls += 1
    return _dense(q, k, v, kv_valid, q_offset, causal)


@counted("launches")
def flash_attention_tc_int8kv_cuda(
    q: torch.Tensor,  # [B, nq, Tq, hd] bf16
    k: torch.Tensor,  # [B, nkv, Tk, hd] int8
    v: torch.Tensor,
    k_scale: torch.Tensor,  # [B, nkv, Tk] fp32
    v_scale: torch.Tensor,
    kv_valid: torch.Tensor,
    q_offset,
    causal: bool = True,
) -> torch.Tensor:
    out = _launch_tc(q, k, v, kv_valid, q_offset, causal, k_scale, v_scale)
    flash_attention_tc_int8kv_cuda.launches += 1
    return out


@counted("calls")
def flash_attention_tc_int8kv_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_scale: torch.Tensor,
    v_scale: torch.Tensor, kv_valid: torch.Tensor, q_offset, causal: bool = True,
) -> torch.Tensor:
    flash_attention_tc_int8kv_plain.calls += 1
    return _dense(q, k, v, kv_valid, q_offset, causal, k_scale, v_scale)


@counted("launches")
def flash_attention_tc_lse_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: torch.Tensor,
    q_offset: int, causal: bool = True,
):
    """The bf16 training forward on tensor cores: ``(out, lse)``."""
    res = _launch_tc(q, k, v, kv_valid, q_offset, causal, lse=True)
    flash_attention_tc_lse_cuda.launches += 1
    return res


@counted("calls")
def flash_attention_tc_lse_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: torch.Tensor,
    q_offset: int, causal: bool = True,
):
    flash_attention_tc_lse_plain.calls += 1
    return _dense(q, k, v, kv_valid, q_offset, causal, lse=True)


def _launch_bwd(q, k, v, kv_valid, q_offset, causal, lse, delta, dout, want_dq: bool,
                tc: bool = False):
    """Launch the fp32-precision backward (fp32 or bf16): the 3xTF32 dq or
    dk/dv (``csrc/flash_attention_tf32.cu``); or, with ``tc``, the bf16
    tensor-core one (``csrc/flash_attention_bwd_tc.cu``): dq, or (dk, dv)."""
    kvv, shape = _check(q, k, v, kv_valid)
    if tc and q.dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core flash backward takes bfloat16 q, got {q.dtype}")
    require("lse", lse, q, q.shape[:3], torch.float32)
    require("delta", delta, q, q.shape[:3], torch.float32)
    require("dout", dout, q, q.shape)
    tail = (*shape, int(q_offset), int(bool(causal)))
    tail += (stream_of(q),) if tc else (dtype_code(q), stream_of(q))
    lib = load_library()
    if not tc:
        q, k, v, dout = _aligned16(q, k, v, dout)
    operands = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kvv.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dout.data_ptr())
    kind = "tensor-core flash attention" if tc else "flash attention"
    if want_dq:
        dq = torch.empty_like(q)
        fn = lib.l32_flash_attn_bwd_dq_tc if tc else lib.l32_flash_attn_tf32_bwd_dq
        check(fn(*operands, dq.data_ptr(), *tail), f"{kind} dq kernel")
        return dq
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = lib.l32_flash_attn_bwd_dkv_tc if tc else lib.l32_flash_attn_tf32_bwd_dkv
    check(fn(*operands, dk.data_ptr(), dv.data_ptr(), *tail), f"{kind} dk/dv kernel")
    return dk, dv


@counted("launches")
def flash_attention_bwd_dq_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: torch.Tensor, q_offset: int,
    causal: bool, lse: torch.Tensor, delta: torch.Tensor, dout: torch.Tensor,
) -> torch.Tensor:
    """dq ``[B, nq, Tq, hd]`` from the forward's lse and ``delta =
    rowsum(dO * O)`` (both ``[B, nq, Tq]`` fp32)."""
    dq = _launch_bwd(q, k, v, kv_valid, q_offset, causal, lse, delta, dout, want_dq=True)
    flash_attention_bwd_dq_cuda.launches += 1
    return dq


@counted("calls")
def flash_attention_bwd_dq_plain(q, k, v, kv_valid, q_offset, causal, lse, delta, dout):
    flash_attention_bwd_dq_plain.calls += 1
    return _dense_bwd(q, k, v, kv_valid, q_offset, causal, lse, delta, dout)[0]


@counted("launches")
def flash_attention_bwd_dkv_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: torch.Tensor, q_offset: int,
    causal: bool, lse: torch.Tensor, delta: torch.Tensor, dout: torch.Tensor,
):
    """``(dk, dv)``, each ``[B, nkv, Tk, hd]``, summed over the group."""
    res = _launch_bwd(q, k, v, kv_valid, q_offset, causal, lse, delta, dout, want_dq=False)
    flash_attention_bwd_dkv_cuda.launches += 1
    return res


@counted("calls")
def flash_attention_bwd_dkv_plain(q, k, v, kv_valid, q_offset, causal, lse, delta, dout):
    flash_attention_bwd_dkv_plain.calls += 1
    return _dense_bwd(q, k, v, kv_valid, q_offset, causal, lse, delta, dout)[1:]


@counted("launches")
def flash_attention_bwd_dq_tc_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: torch.Tensor, q_offset: int,
    causal: bool, lse: torch.Tensor, delta: torch.Tensor, dout: torch.Tensor,
) -> torch.Tensor:
    """The bf16 dq on tensor cores: p and ds rounded to bf16 before ``ds k``."""
    dq = _launch_bwd(q, k, v, kv_valid, q_offset, causal, lse, delta, dout, want_dq=True, tc=True)
    flash_attention_bwd_dq_tc_cuda.launches += 1
    return dq


@counted("calls")
def flash_attention_bwd_dq_tc_plain(q, k, v, kv_valid, q_offset, causal, lse, delta, dout):
    flash_attention_bwd_dq_tc_plain.calls += 1
    return _dense_bwd(q, k, v, kv_valid, q_offset, causal, lse, delta, dout, round_to_q=True)[0]


@counted("launches")
def flash_attention_bwd_dkv_tc_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: torch.Tensor, q_offset: int,
    causal: bool, lse: torch.Tensor, delta: torch.Tensor, dout: torch.Tensor,
):
    """The bf16 ``(dk, dv)`` on tensor cores: p and ds rounded to bf16
    before ``p^T dO`` and ``ds^T q``."""
    res = _launch_bwd(q, k, v, kv_valid, q_offset, causal, lse, delta, dout, want_dq=False,
                      tc=True)
    flash_attention_bwd_dkv_tc_cuda.launches += 1
    return res


@counted("calls")
def flash_attention_bwd_dkv_tc_plain(q, k, v, kv_valid, q_offset, causal, lse, delta, dout):
    flash_attention_bwd_dkv_tc_plain.calls += 1
    return _dense_bwd(q, k, v, kv_valid, q_offset, causal, lse, delta, dout, round_to_q=True)[1:]


def allowed_mask(kv_valid, q_offset, causal, tq, tk, device):
    """The keys each query may see: bool ``[B, 1, 1, Tq or 1, Tk]``."""
    allowed = kv_valid.bool()[:, None, None, None, :]  # [B, 1, 1, 1, Tk]
    if causal:
        kpos = torch.arange(tk, device=device)
        if isinstance(q_offset, torch.Tensor):  # per row: [B, 1, 1, Tq, Tk]
            qpos = q_offset.to(device).long()[:, None] + torch.arange(tq, device=device)
            allowed = allowed & (kpos <= qpos[:, None, None, :, None])
        else:
            qpos = int(q_offset) + torch.arange(tq, device=device)
            allowed = allowed & (kpos[None, :] <= qpos[:, None])
    return allowed


def _dense(q, k, v, kv_valid, q_offset, causal, k_scale=None, v_scale=None, lse=False):
    b, nq, tq, hd = q.shape
    nkv, tk = k.shape[1], k.shape[2]
    acc = acc_dtype(q)
    qg = q.to(acc).reshape(b, nkv, nq // nkv, tq, hd)
    scores = torch.einsum("bkgqd,bktd->bkgqt", qg, k.to(acc))
    if k_scale is not None:
        scores = scores * k_scale.to(acc)[:, :, None, None, :]
    allowed = allowed_mask(kv_valid, q_offset, causal, tq, tk, q.device)
    logits = torch.where(allowed, scores * (1.0 / math.sqrt(hd)), float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom > 0, denom, torch.ones_like(denom))
    if v_scale is not None:  # re-masked: blocked slots' scales never reach the sum
        p = torch.where(allowed, p * v_scale.to(acc)[:, :, None, None, :], 0.0)
    ctx = torch.einsum("bkgqt,bktd->bkgqd", p, v.to(acc))
    out = ctx.reshape(b, nq, tq, hd).to(q.dtype)
    if not lse:
        return out
    row_lse = torch.where(denom > 0, m + torch.log(denom), torch.full_like(m, NEG_BIG))
    return out, row_lse.reshape(b, nq, tq).float()


def _dense_bwd(q, k, v, kv_valid, q_offset, causal, lse, delta, dout, round_to_q=False):
    """The backward formula with dense scores: ``(dq, dk, dv)``. With
    ``round_to_q`` (the tensor-core kernels, as the Pallas kernels), p and
    ds are rounded to q's dtype before the products that take them."""
    b, nq, tq, hd = q.shape
    nkv, tk = k.shape[1], k.shape[2]
    g = nq // nkv
    acc = acc_dtype(q)
    scale = 1.0 / math.sqrt(hd)
    qg = q.to(acc).reshape(b, nkv, g, tq, hd)
    dog = dout.to(acc).reshape(b, nkv, g, tq, hd)
    kf, vf = k.to(acc), v.to(acc)
    allowed = allowed_mask(kv_valid, q_offset, causal, tq, tk, q.device)
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, kf)
    logits = s * scale - lse.to(acc).reshape(b, nkv, g, tq, 1)
    p = torch.exp(torch.where(allowed, logits, float("-inf")))
    dp = torch.einsum("bkgqd,bktd->bkgqt", dog, vf)
    ds = p * (dp - delta.to(acc).reshape(b, nkv, g, tq, 1)) * scale
    if round_to_q:
        p, ds = p.to(q.dtype).to(acc), ds.to(q.dtype).to(acc)
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, kf).reshape(b, nq, tq, hd)
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, qg)
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
