"""LLaMA-3.2 text decoder (counterpart of ``llama32mm_tpu/models/language.py``).

Reference semantics kept from the JAX package:

- the √hidden_size embedding scale, in the activation dtype;
- ids clamped for the lookup (the ``<image>`` id may equal the vocab size;
  its positions are overwritten by the splice);
- the residual-stream drop: a block returns ``attn_out + ff_out`` where the
  FFN input is ``norm2(attn_out + h)`` and ``h`` is not added back;
- post-RoPE keys written to the cache before attention (quantized first in
  the int8 cache mode, attention then reading the int8 cache and its scales);
- tied (the ``[vocab, hidden]`` embedding) or untied head;
- quantized linears (``QuantLinear``, from ``models/quantize.py``) through
  ``ops/gemv.py::qlinear``; with quantized gate/up the FFN takes the explicit
  ``silu(gate) * up`` form instead of the fused SwiGLU, as in JAX.

One module per layer (no ``[L, ...]`` stacks). Float linears with at most 32
input rows run the decode gemv kernel, others a plain matmul
(``ops/gemv.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from llama32mm_tpu_torch.configs import LLAMA32Config
from llama32mm_tpu_torch.models.common import Linear, Norm, empty_param
from llama32mm_tpu_torch.ops.attention import AttnMask, gqa_attention
from llama32mm_tpu_torch.ops.dispatch import not_in_slice
from llama32mm_tpu_torch.ops.gemv import linear
from llama32mm_tpu_torch.ops.quant import is_quantized
from llama32mm_tpu_torch.ops.rmsnorm import fused_add_rmsnorm
from llama32mm_tpu_torch.ops.rope import apply_rotary_pos_emb, rope_cos_sin
from llama32mm_tpu_torch.ops.swiglu import fused_swiglu
from llama32mm_tpu_torch.utils.kvcache import KVCache


class Attention(nn.Module):
    def __init__(self, config: LLAMA32Config, device, dtype):
        super().__init__()
        h, hd = config.hidden_size, config.head_dim
        self.W_query = Linear(h, config.n_heads * hd, False, device, dtype)
        self.W_key = Linear(h, config.n_kv_groups * hd, False, device, dtype)
        self.W_value = Linear(h, config.n_kv_groups * hd, False, device, dtype)
        self.out_proj = Linear(config.n_heads * hd, h, False, device, dtype)


class FeedForward(nn.Module):
    def __init__(self, config: LLAMA32Config, device, dtype):
        super().__init__()
        h, inter = config.hidden_size, config.hidden_dim
        self.w_gate = Linear(h, inter, False, device, dtype)
        self.w_up = Linear(h, inter, False, device, dtype)
        self.w_down = Linear(inter, h, False, device, dtype)


class DecoderBlock(nn.Module):
    def __init__(self, config: LLAMA32Config, device, dtype):
        super().__init__()
        self.norm1 = Norm(config.hidden_size, False, device, dtype)
        self.att = Attention(config, device, dtype)
        self.norm2 = Norm(config.hidden_size, False, device, dtype)
        self.ff = FeedForward(config, device, dtype)


class LlamaModel(nn.Module):
    def __init__(self, config: LLAMA32Config, device, dtype):
        super().__init__()
        self.tok_emb = empty_param(config.vocab_size, config.hidden_size, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(DecoderBlock(config, device, dtype) for _ in range(config.n_layers))
        self.final_norm = Norm(config.hidden_size, False, device, dtype)


class CausalLM(nn.Module):
    """Decoder plus head; ``lm_head`` is None when tied to the embedding."""

    def __init__(self, config: LLAMA32Config, device, dtype, tie_weights: bool = True):
        super().__init__()
        self.config = config
        self.model = LlamaModel(config, device, dtype)
        self.lm_head = None if tie_weights else Linear(
            config.hidden_size, config.vocab_size, False, device, dtype)

    def init_(self, gen: torch.Generator) -> None:
        """The JAX package's ``init_causal_lm_params`` distributions."""
        self.model.tok_emb.normal_(generator=gen)
        if self.config.pad_token_index is not None:
            self.model.tok_emb[self.config.pad_token_index] = 0.0
        for mod in self.model.modules():
            if isinstance(mod, Linear):
                mod.init_(gen)
            elif isinstance(mod, Norm):
                mod.init_()
        if self.lm_head is not None:
            self.lm_head.init_(gen)


class LlamaOutput(NamedTuple):
    hidden_states: torch.Tensor
    kv_cache: Optional[KVCache]


def _block_forward(h, block: DecoderBlock, layer_idx: int, config: LLAMA32Config, cos, sin,
                   structured: AttnMask, kv_cache: Optional[KVCache], impl: str):
    b, t, _ = h.shape
    nq, nkv, hd = config.n_heads, config.n_kv_groups, config.head_dim
    att, ff = block.att, block.ff

    normed = fused_add_rmsnorm(h, block.norm1.weight, config.rms_norm_eps, impl=impl)
    q = linear(normed, att.W_query.weight, impl).reshape(b, t, nq, hd).transpose(1, 2)
    k = linear(normed, att.W_key.weight, impl).reshape(b, t, nkv, hd).transpose(1, 2)
    v = linear(normed, att.W_value.weight, impl).reshape(b, t, nkv, hd).transpose(1, 2)
    q, k = apply_rotary_pos_emb(q, k, cos, sin)
    k_scale = v_scale = None
    if kv_cache is not None:  # post-RoPE keys cached; int8 caches return their scales
        k, v, k_scale, v_scale = kv_cache.update(layer_idx, k, v)

    attn = gqa_attention(q, k, v, structured, causal=True, impl=impl,
                         k_scale=k_scale, v_scale=v_scale)
    attn = attn.transpose(1, 2).reshape(b, t, nq * hd)
    attn_out = linear(attn, att.out_proj.weight, impl)

    normed_ff = fused_add_rmsnorm(
        attn_out, block.norm2.weight, config.rms_norm_eps, residual=h, impl=impl
    )
    w_gate, w_up = ff.w_gate.weight, ff.w_up.weight
    if is_quantized(w_gate) or is_quantized(w_up):
        gate = linear(normed_ff, w_gate, impl)
        up = linear(normed_ff, w_up, impl)
        inter = (F.silu(gate.float()) * up.float()).to(gate.dtype)
    else:
        inter = fused_swiglu(normed_ff, w_gate, w_up, impl=impl)
    ff_out = linear(inter, ff.w_down.weight, impl)
    # residual-stream drop: the block input h is not added back
    return attn_out + ff_out


def _structured_mask(attention_mask, b: int, t: int, kv_cache: Optional[KVCache],
                     device) -> AttnMask:
    if isinstance(attention_mask, AttnMask):
        return attention_mask
    if attention_mask is not None and attention_mask.dim() != 2:
        not_in_slice("a dense 4D attention mask (pass an AttnMask)")
    base = (torch.ones(b, t, dtype=torch.int32, device=device) if attention_mask is None
            else attention_mask.to(torch.int32))
    if kv_cache is None:
        return AttnMask(kv_valid=base, q_offset=0)
    # the 2D mask covers the current tokens; cached slots are valid
    pos = kv_cache.pos
    kv_valid = torch.zeros(b, kv_cache.max_length, dtype=torch.int32, device=device)
    kv_valid[:, :pos] = 1
    kv_valid[:, pos:pos + t] = base
    return AttnMask(kv_valid=kv_valid, q_offset=pos)


def llama_forward(
    model: LlamaModel,
    config: LLAMA32Config,
    input_ids: Optional[torch.Tensor] = None,
    input_embeds: Optional[torch.Tensor] = None,
    attention_mask: Union[AttnMask, torch.Tensor, None] = None,
    position_ids: Optional[torch.Tensor] = None,
    kv_cache: Optional[KVCache] = None,
    impl: str = "auto",
    lora=None,
    remat: bool = False,
    gemv_routes=None,
    collect_stats: bool = False,
) -> LlamaOutput:
    """Decoder forward. With a ``kv_cache`` the new keys and values are written
    at ``kv_cache.pos`` in place and ``pos`` advances by the sequence length;
    the returned cache is the same object."""
    for name, on in (("LoRA", lora is not None), ("remat", remat),
                     ("gemv_routes", gemv_routes is not None), ("collect_stats", collect_stats)):
        if on:
            not_in_slice(name)
    if input_embeds is not None:
        h = input_embeds
    elif input_ids is not None:
        h = model.tok_emb[input_ids.clamp(0, config.vocab_size - 1)]
    else:
        raise ValueError("Either input_ids or input_embeds must be provided")

    b, t, _ = h.shape
    # a 0-dim host tensor: no host-to-device copy (and stream sync) per forward
    h = h * torch.tensor(math.sqrt(config.hidden_size), dtype=h.dtype)
    structured = _structured_mask(attention_mask, b, t, kv_cache, h.device)

    if position_ids is None:
        pos0 = kv_cache.pos if kv_cache is not None else 0
        position_ids = (pos0 + torch.arange(t, device=h.device))[None].expand(b, t)
    scaling = config.rope_freq_dict if config.apply_rope_scaling else None
    cos, sin = rope_cos_sin(position_ids, config.head_dim, config.rope_base, h.dtype, scaling)

    for i, block in enumerate(model.blocks):
        h = _block_forward(h, block, i, config, cos, sin, structured, kv_cache, impl)
    if kv_cache is not None:
        kv_cache.advance(t)

    h = fused_add_rmsnorm(h, model.final_norm.weight, config.rms_norm_eps, impl=impl)
    return LlamaOutput(hidden_states=h, kv_cache=kv_cache)


def lm_head_apply(lm: CausalLM, config: LLAMA32Config, hidden: torch.Tensor,
                  impl: str = "auto") -> torch.Tensor:
    """Logits; a tied head reads the ``[vocab, hidden]`` embedding as it is,
    a quantized head goes through ``qlinear``."""
    w = lm.model.tok_emb if lm.lm_head is None else lm.lm_head.weight
    return linear(hidden, w, impl)


def causal_lm_forward(lm: CausalLM, config: LLAMA32Config, input_ids=None, input_embeds=None,
                      attention_mask=None, position_ids=None, kv_cache=None,
                      impl: str = "auto"):
    """``(logits, kv_cache)``."""
    out = llama_forward(lm.model, config, input_ids=input_ids, input_embeds=input_embeds,
                        attention_mask=attention_mask, position_ids=position_ids,
                        kv_cache=kv_cache, impl=impl)
    return lm_head_apply(lm, config, out.hidden_states, impl=impl), out.kv_cache
