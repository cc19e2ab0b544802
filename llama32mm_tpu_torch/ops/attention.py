"""GQA attention with the structured mask (counterpart of
``llama32mm_tpu/ops/attention.py``).

Mask-then-scale softmax: allowed logits are ``q·k / sqrt(hd)``, blocked keys
get probability exactly 0 (PARITY.md row 3). The mask is structured,
``AttnMask(kv_valid [B, Tk], q_offset)``: per-key validity plus the absolute
position of query row 0, from which the causal limit follows. Every call,
prefill, decode and the ViT's non-causal attention alike, goes through the
flash kernel on the card. With an int8 KV cache, ``k``/``v`` are int8 and
their per-position fp32 scales ``k_scale``/``v_scale`` fold into the scores
and the attention weights, in the int8-KV instantiation of the kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from llama32mm_tpu_torch.ops.cuda.attention import (
    flash_attention_cuda,
    flash_attention_int8kv_cuda,
    flash_attention_int8kv_plain,
    flash_attention_plain,
)
from llama32mm_tpu_torch.ops.dispatch import not_in_slice, resolve_impl


class AttnMask(NamedTuple):
    """Which key slots are valid, and the absolute position of query row 0."""

    kv_valid: torch.Tensor  # [B, Tk] bool/int
    q_offset: int


def dense_from_structured(mask: AttnMask, tq: int, tk: int, dtype: torch.dtype,
                          causal: bool = True) -> torch.Tensor:
    """The additive ``[B, 1, Tq, Tk]`` mask with the reference's semantics:
    ``finfo.min`` on invalid keys, ``-inf`` on acausal positions."""
    neg = torch.finfo(dtype).min
    valid = mask.kv_valid.bool()
    add = torch.where(valid, torch.zeros((), dtype=dtype, device=valid.device),
                      torch.full((), neg, dtype=dtype, device=valid.device))[:, None, None, :]
    if causal:
        kpos = torch.arange(tk, device=valid.device)[None, :]
        qpos = int(mask.q_offset) + torch.arange(tq, device=valid.device)[:, None]
        c = torch.where(kpos > qpos, float("-inf"), 0.0).to(dtype)
        add = add + c[None, None]
    return add


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
    tail = (structured.kv_valid, int(structured.q_offset), causal)
    kernel, plain = flash_attention_cuda, flash_attention_plain
    operands = (q.contiguous(), k.contiguous(), v.contiguous())
    if k_scale is not None:
        kernel, plain = flash_attention_int8kv_cuda, flash_attention_int8kv_plain
        operands += (k_scale.contiguous(), v_scale.contiguous())
    if resolve_impl(impl, q) == "cuda":
        return kernel(*operands, *tail)
    return plain(*operands, *tail)

