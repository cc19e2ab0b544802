"""GQA attention with the structured mask (counterpart of
``llama32mm_tpu/ops/attention.py``).

Mask-then-scale softmax: allowed logits are ``q·k / sqrt(hd)``, blocked keys
get probability exactly 0 (PARITY.md row 3). The mask is structured,
``AttnMask(kv_valid [B, Tk], q_offset)``: per-key validity plus the absolute
position of query row 0, from which the causal limit follows. Every call,
prefill, decode and the ViT's non-causal attention alike, goes through a
flash kernel on the card; ``_route`` picks which one from the call's shape
and types:

- a call with few query rows per kv head (``Tq * G <= DECODE_MAX_ROWS``;
  decode) goes to the split-KV decode kernel, which reads each K/V byte once
  for the whole group of query heads;
- a longer bf16 call (prefill, the ViT) goes to the tensor-core forward;
- a longer fp32 call goes to the SIMT forward.

``q_offset`` is one int, or an int ``[B]`` tensor when the rows sit at
different fill levels (the continuous-batching server's decode): the
kernels take it as it is, with no dense mask (the JAX package densifies a
per-row offset and leaves it to XLA). With an int8 KV cache, ``k``/``v`` are
int8 and their per-position fp32 scales ``k_scale``/``v_scale`` fold into
the scores and the attention weights, in each kernel's int8-KV
instantiation.

Under autograd the float path is a ``torch.autograd.Function`` (the Pallas
custom VJP ``_flash_train``): the forward with the log-sum-exp (tensor-core
for bf16, SIMT for fp32), then the dq and dk/dv kernels. The int8-KV path is
inference-only, as in the JAX package, and raises under autograd. On the
CPU the same route picks each kernel's plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from llama32mm_tpu_torch.ops.cuda import KERNELS
from llama32mm_tpu_torch.ops.cuda.attention import (
    flash_attention_bwd_dkv_cuda,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq_cuda,
    flash_attention_bwd_dq_plain,
)
from llama32mm_tpu_torch.ops.cuda.flash_decode import DECODE_MAX_ROWS
from llama32mm_tpu_torch.ops.dispatch import needs_grad, not_in_slice, resolve_impl


class AttnMask(NamedTuple):
    """Which key slots are valid, and the absolute position of query row 0."""

    kv_valid: torch.Tensor  # [B, Tk] bool/int
    q_offset: Union[int, torch.Tensor]  # one int, or int [B] (per row)


def dense_from_structured(mask: AttnMask, tq: int, tk: int, dtype: torch.dtype,
                          causal: bool = True) -> torch.Tensor:
    """The additive ``[B, 1, Tq, Tk]`` mask with the reference's semantics:
    ``finfo.min`` on invalid keys, ``-inf`` on acausal positions."""
    neg = torch.finfo(dtype).min
    valid = mask.kv_valid.bool()
    add = torch.where(valid, torch.zeros((), dtype=dtype, device=valid.device),
                      torch.full((), neg, dtype=dtype, device=valid.device))[:, None, None, :]
    if causal:
        kpos = torch.arange(tk, device=valid.device)
        qrange = torch.arange(tq, device=valid.device)
        if isinstance(mask.q_offset, torch.Tensor):  # per row: [B, 1, Tq, Tk]
            qpos = mask.q_offset.to(valid.device).long()[:, None] + qrange
            c = torch.where(kpos > qpos[:, :, None], float("-inf"), 0.0).to(dtype)[:, None]
        else:
            qpos = int(mask.q_offset) + qrange
            c = torch.where(kpos[None, :] > qpos[:, None], float("-inf"), 0.0).to(dtype)[None, None]
        add = add + c
    return add


def _route(dtype: torch.dtype, tq: int, group: int, int8_kv: bool, grad: bool) -> str:
    """The ``KERNELS`` name of the forward a call goes through: ``tq`` query
    rows per head, ``group`` = nq / nkv query heads per kv head."""
    if grad:
        return "flash_attention_tc_lse" if dtype == torch.bfloat16 else "flash_attention_lse"
    if tq * group <= DECODE_MAX_ROWS:
        return "flash_decode_int8kv" if int8_kv else "flash_decode"
    if dtype == torch.bfloat16:
        return "flash_attention_tc_int8kv" if int8_kv else "flash_attention_tc"
    return "flash_attention_int8kv" if int8_kv else "flash_attention"


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_valid, q_offset, causal, impl, fwd_name):
        cuda = impl == "cuda"
        out, lse = KERNELS[fwd_name][0 if cuda else 1](q, k, v, kv_valid, q_offset, causal)
        ctx.save_for_backward(q, k, v, kv_valid, out, lse)
        ctx.q_offset, ctx.causal, ctx.cuda = q_offset, causal, cuda
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)  # rowsum(dO * O), as JAX's XLA op
        args = (q, k, v, kv_valid, ctx.q_offset, ctx.causal, lse, delta, dout)
        dq = dk = dv = None
        if ctx.needs_input_grad[0]:
            dq = (flash_attention_bwd_dq_cuda if ctx.cuda else flash_attention_bwd_dq_plain)(*args)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dkv = flash_attention_bwd_dkv_cuda if ctx.cuda else flash_attention_bwd_dkv_plain
            dk, dv = dkv(*args)
        return dq, dk, dv, None, None, None, None, None


def gqa_attention(
    q: torch.Tensor,  # [B, nq, Tq, hd], RoPE applied
    k: torch.Tensor,  # [B, nkv, Tk, hd]
    v: torch.Tensor,
    structured: AttnMask,
    causal: bool = True,
    impl: str = "auto",
    mask: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,  # [B, nkv, Tk] fp32, int8 K only
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Grouped-query attention: query head ``h`` reads kv head
    ``h // (nq // nkv)``. Returns ``[B, nq, Tq, hd]``."""
    if mask is not None:
        not_in_slice("a dense additive attention mask")
    impl = resolve_impl(impl, q)
    q_offset = structured.q_offset
    if not isinstance(q_offset, torch.Tensor):
        q_offset = int(q_offset)
    tail = (structured.kv_valid, q_offset, causal)
    operands = (q.contiguous(), k.contiguous(), v.contiguous())
    grad = needs_grad(q, k, v)
    name = _route(q.dtype, q.shape[2], q.shape[1] // k.shape[1], k_scale is not None, grad)
    if grad:
        if k_scale is not None:
            raise NotImplementedError(
                "gradients through the int8-KV attention: it is inference-only, as in the JAX "
                "package")
        if isinstance(q_offset, torch.Tensor):
            raise NotImplementedError(
                "gradients with per-row query offsets: training batches share one offset")
        kv_valid = structured.kv_valid.to(torch.int32).contiguous()
        return _FlashAttention.apply(*operands, kv_valid, *tail[1:], impl, name)
    if k_scale is not None:
        operands += (k_scale.contiguous(), v_scale.contiguous())
    kernel, plain = KERNELS[name]
    return (kernel if impl == "cuda" else plain)(*operands, *tail)

