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
- a longer fp32 call goes to the fp32 forward on tensor cores (each fp32
  product as three TF32 products, ``csrc/flash_attention_tf32.cu``).

``q_offset`` is one int, or an int ``[B]`` tensor when the rows sit at
different fill levels (the continuous-batching server's decode): the
kernels take it as it is, with no dense mask (the JAX package densifies a
per-row offset and leaves it to XLA). With an int8 KV cache, ``k``/``v`` are
int8 and their per-position fp32 scales ``k_scale``/``v_scale`` fold into
the scores and the attention weights, in each kernel's int8-KV
instantiation.

Under autograd the float path is a ``torch.autograd.Function`` (the Pallas
custom VJP ``_flash_train``): the forward with the log-sum-exp, then the dq
and dk/dv kernels, all three on bf16 tensor cores for bf16, on 3xTF32
tensor cores for fp32 (``_route`` and ``_route_bwd``).
The int8-KV path is inference-only, as in the JAX package, and raises under
autograd. On the CPU the same route picks each kernel's plain version.

A dense additive ``[B, 1, Tq, Tk]`` mask (the reference's own form, which the
JAX ``llama_forward`` passes through) has no structure for a kernel to use:
such a call runs ``dense_attention``, the JAX package's XLA attention in
plain PyTorch, on any device and under autograd.

Sequence parallelism (``sp_mesh``, a mesh with ``sp > 1``; the JAX
package's SPMD rules of ``ops/pallas/attention.py``): each rank holds a
contiguous chunk of the queries, and ``structured.q_offset`` is the global
position of its row 0. Two layouts:

- the ring (unscaled calls, the training path): K/V and their validity row
  stay sequence-sharded. Over ``sp`` steps each rank runs the LSE forward
  on its queries against the chunk it holds, the causal offset rebased to
  that chunk's first key (``q_offset - owner * Tk_loc``, negative for a
  chunk wholly in the future, where every row is masked), merges the
  partial result into fp32 ``(out, lse)`` by ``logaddexp`` (from ``lse =
  NEG_BIG``) and passes the chunk on (``Mesh.ppermute``). The backward
  sends K/V round again with fp32 dk/dv accumulators: each rank adds its
  queries' share through the dq and dk/dv kernels, with the merged LSE and
  ``rowsum(dO * O)`` of the merged output; after ``sp`` hops each
  accumulator is home. Every chunk goes through the kernels, masked ones
  too.
- the all-gather layout (``sp_layout="gather"``, and every int8-KV call):
  K/V (and the scales, the validity row) are all-gathered over ``sp``, each
  rank runs the kernel on its queries against all keys; backward, dk/dv
  are reduce-scattered (summed over the ranks' queries, each rank keeping
  its chunk).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from llama32mm_tpu_torch.ops.cuda import KERNELS
from llama32mm_tpu_torch.ops.cuda.attention import NEG_BIG
from llama32mm_tpu_torch.ops.cuda.flash_decode import DECODE_MAX_ROWS
from llama32mm_tpu_torch.ops.dispatch import needs_grad, resolve_impl
from llama32mm_tpu_torch.parallel.mesh import AXIS_SP, all_gather


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


def _route_bwd(dtype: torch.dtype) -> tuple:
    """The ``KERNELS`` names of the dq and dk/dv kernels a training call's
    backward goes through: the tensor-core pair for bf16, the fp32 pair (the
    3xTF32 dq and dk/dv) for fp32 (and the fp64 of the gradient checks, on
    the CPU)."""
    if dtype == torch.bfloat16:
        return "flash_attention_bwd_dq_tc", "flash_attention_bwd_dkv_tc"
    return "flash_attention_bwd_dq", "flash_attention_bwd_dkv"


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_valid, q_offset, causal, impl, fwd_name, bwd_names):
        cuda = impl == "cuda"
        out, lse = KERNELS[fwd_name][0 if cuda else 1](q, k, v, kv_valid, q_offset, causal)
        ctx.save_for_backward(q, k, v, kv_valid, out, lse)
        ctx.q_offset, ctx.causal, ctx.cuda, ctx.bwd_names = q_offset, causal, cuda, bwd_names
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)  # rowsum(dO * O), as JAX's XLA op
        args = (q, k, v, kv_valid, ctx.q_offset, ctx.causal, lse, delta, dout)
        dq_fn, dkv_fn = (KERNELS[name][0 if ctx.cuda else 1] for name in ctx.bwd_names)
        dq = dk = dv = None
        if ctx.needs_input_grad[0]:
            dq = dq_fn(*args)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = dkv_fn(*args)
        return dq, dk, dv, None, None, None, None, None, None


def _ring_merge(out, lse, o_s, lse_s):
    """Online-softmax merge of a chunk's normalized partial attention into
    the fp32 running ``(out, lse)``; a chunk with no allowed key (output 0,
    ``lse_s = NEG_BIG``) changes neither."""
    new = torch.logaddexp(lse, lse_s)
    out = out * torch.exp(lse - new)[..., None] + o_s.float() * torch.exp(lse_s - new)[..., None]
    return out, new


class _RingFlashAttention(torch.autograd.Function):
    """Ring attention over ``sp`` (see the module's notes): the hand LSE
    forward, dq and dk/dv kernels on every (query chunk, key chunk) pair."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, q_offset, causal, impl, bwd_names, mesh):
        cuda = impl == "cuda"
        fwd = KERNELS[_route(q.dtype, q.shape[2], 1, False, True)][0 if cuda else 1]
        n, me, tk = mesh.shape[AXIS_SP], mesh.rank(AXIS_SP), k.shape[2]
        out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(q.shape[:3], NEG_BIG, dtype=torch.float32, device=q.device)
        chunk = (k, v, kv_valid)
        for s in range(n):
            owner = (me - s) % n
            o_s, lse_s = fwd(q, *chunk, q_offset - owner * tk, causal)
            out, lse = _ring_merge(out, lse, o_s, lse_s)
            if s < n - 1:
                chunk = tuple(mesh.ppermute(t, AXIS_SP) for t in chunk)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, kv_valid, out, lse)
        ctx.q_offset, ctx.causal, ctx.cuda, ctx.bwd_names, ctx.mesh = (
            q_offset, causal, cuda, bwd_names, mesh)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        mesh = ctx.mesh
        n, me, tk = mesh.shape[AXIS_SP], mesh.rank(AXIS_SP), k.shape[2]
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)  # of the merged output
        dq_fn, dkv_fn = (KERNELS[name][0 if ctx.cuda else 1] for name in ctx.bwd_names)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        chunk = (k, v, kv_valid)
        for s in range(n):
            owner = (me - s) % n
            args = (q, *chunk, ctx.q_offset - owner * tk, ctx.causal, lse, delta, dout)
            dq += dq_fn(*args).float()
            dk_s, dv_s = dkv_fn(*args)
            dk += dk_s.float()
            dv += dv_s.float()
            if s < n - 1:
                chunk = tuple(mesh.ppermute(t, AXIS_SP) for t in chunk)
            # the accumulators travel with their chunk; the last hop brings them home
            dk, dv = mesh.ppermute(dk, AXIS_SP), mesh.ppermute(dv, AXIS_SP)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None,
                None)


def _seq_parallel_attention(q, k, v, structured: AttnMask, causal: bool, impl: str, mesh,
                            layout: str, k_scale, v_scale) -> torch.Tensor:
    """Attention of this rank's query chunk over the whole sequence, whose
    keys are sharded over ``sp`` like the queries (the module's notes)."""
    q_offset = structured.q_offset
    if isinstance(q_offset, torch.Tensor):
        raise NotImplementedError("per-row query offsets under sequence parallelism")
    q_offset = int(q_offset)
    kv_valid = structured.kv_valid.to(torch.int32).contiguous()
    if layout not in ("ring", "gather"):
        raise ValueError(f"sp_layout must be 'ring' or 'gather', got {layout!r}")
    if layout == "gather" or k_scale is not None:
        k, v = (all_gather(t, mesh, AXIS_SP, dim=2) for t in (k, v))
        if k_scale is not None:
            k_scale, v_scale = (mesh.all_gather(t, AXIS_SP, dim=2) for t in (k_scale, v_scale))
        whole = AttnMask(mesh.all_gather(kv_valid, AXIS_SP, dim=1), q_offset)
        return gqa_attention(q, k, v, whole, causal, impl, k_scale=k_scale, v_scale=v_scale)
    impl = resolve_impl(impl, q)
    return _RingFlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), kv_valid,
                                     q_offset, causal, impl, _route_bwd(q.dtype), mesh)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``softmax((q·kᵀ + mask) / sqrt(hd)) · v`` with a dense additive mask
    ``[B, 1, Tq, Tk]``, in the activation dtype, grouped-query heads, and
    int8 K/V scales folded into the scores and the weights (the JAX
    package's ``_gqa_attention_xla``)."""
    b, n_q, t_q, hd = q.shape
    n_kv = k.shape[1]
    qg = q.reshape(b, n_kv, n_q // n_kv, t_q, hd)
    scores = torch.einsum("bkgqd,bkTd->bkgqT", qg, k.to(q.dtype))
    if k_scale is not None:
        scores = (scores.float() * k_scale[:, :, None, None, :]).to(scores.dtype)
    scores = scores + mask.to(scores.dtype)[:, :, None, :, :]
    scale = torch.tensor(hd, dtype=scores.dtype) ** 0.5
    weights = torch.softmax(scores / scale, dim=-1)
    if v_scale is not None:
        weights = (weights.float() * v_scale[:, :, None, None, :]).to(weights.dtype)
    ctx = torch.einsum("bkgqT,bkTd->bkgqd", weights, v.to(q.dtype))
    return ctx.reshape(b, n_q, t_q, hd)


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
    sp_mesh=None,
    sp_layout: str = "ring",
) -> torch.Tensor:
    """Grouped-query attention: query head ``h`` reads kv head
    ``h // (nq // nkv)``. Returns ``[B, nq, Tq, hd]``. A dense additive
    ``mask`` takes the place of ``structured`` (``dense_attention``).
    ``sp_mesh`` (a mesh with ``sp > 1``): ``q``, ``k``, ``v`` and
    ``structured.kv_valid`` are this rank's sequence chunks,
    ``structured.q_offset`` the global position of its query row 0, and
    ``sp_layout`` the ring or the all-gather layout (the module's notes)."""
    if sp_mesh is not None and sp_mesh.shape[AXIS_SP] > 1:
        if mask is not None:
            raise ValueError("a dense mask under sequence parallelism: pass the structured one")
        return _seq_parallel_attention(q, k, v, structured, causal, impl, sp_mesh, sp_layout,
                                       k_scale, v_scale)
    if mask is not None:
        return dense_attention(q, k, v, mask, k_scale, v_scale)
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
        return _FlashAttention.apply(*operands, kv_valid, *tail[1:], impl, name,
                                     _route_bwd(q.dtype))
    if k_scale is not None:
        operands += (k_scale.contiguous(), v_scale.contiguous())
    kernel, plain = KERNELS[name]
    return (kernel if impl == "cuda" else plain)(*operands, *tail)

