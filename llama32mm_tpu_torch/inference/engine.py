"""Inference engine: prefill into a preallocated KV cache, then a KV-cached
decode loop (counterpart of ``llama32mm_tpu/inference/engine.py``).

The JAX engine compiles the whole generate call into one program; here it is
a Python loop over eager steps under ``torch.inference_mode()``. The eos
check reads one flag from the device per step. ``kv_dtype="int8"`` serves
from the int8 KV cache (``utils/kvcache.py``); a model quantized by
``models/quantize.py::quantize_llama_params`` serves its quantized linears.

Positions, as in the JAX engine: a prompt may be right-padded (by the caller
or by ``prompt_buckets``). Decode step ``i`` writes its token's keys at cache
slot ``s + i - 1`` of the padded prompt (``q_offset``), so padded slots stay
blocked by ``kv_valid``, while its RoPE position continues the row's true
length: ``true_len + i - 1``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from llama32mm_tpu_torch.configs import MLLAMAConfig
from llama32mm_tpu_torch.models.vlm import MllamaForConditionalGeneration, vlm_forward
from llama32mm_tpu_torch.ops.attention import AttnMask
from llama32mm_tpu_torch.ops.dispatch import not_in_slice
from llama32mm_tpu_torch.utils.kvcache import init_kv_cache
from llama32mm_tpu_torch.utils.sampling import presence_from_tokens, select_next_token


def structured_prefill_mask(padding_mask: torch.Tensor, max_len: int) -> AttnMask:
    """``[B, S]`` padding mask → prompt keys valid per padding, cache tail
    invalid, queries starting at position 0."""
    s = padding_mask.shape[1]
    kv_valid = F.pad(padding_mask.to(torch.int32), (0, max_len - s))
    return AttnMask(kv_valid=kv_valid, q_offset=0)


def structured_decode_mask(padding_mask: torch.Tensor, cur_len: int, max_len: int) -> AttnMask:
    """Decode step: prompt padding stays blocked, slots below ``cur_len``
    are valid, the one query sits at position ``cur_len - 1``."""
    s = padding_mask.shape[1]
    k = torch.arange(max_len, device=padding_mask.device)[None, :]
    pad_ok = F.pad(padding_mask.to(torch.int32), (0, max_len - s), value=1).bool()
    kv_valid = ((k < cur_len) & pad_ok).to(torch.int32)
    return AttnMask(kv_valid=kv_valid, q_offset=cur_len - 1)


def bucketed_len(s: int, max_new_tokens: int, cache_len: int, buckets) -> int:
    """Smallest bucket ≥ s whose generation still fits the cache; ``"auto"``
    is the next multiple of 128; the exact length when no bucket fits."""
    if buckets is None:
        return s
    room = cache_len - max_new_tokens
    if buckets == "auto":
        cand = min(-(-s // 128) * 128, room)
        return cand if cand >= s else s
    for b in buckets:
        if s <= b <= room:
            return b
    return s


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_new_tokens]: ids, eos after a row stops, 0 after all stop
    num_generated: torch.Tensor  # [B] valid tokens per row, eos included
    prefill_logits: torch.Tensor  # [B, V] logits at the last prompt position
    steps: Optional[torch.Tensor] = None  # speculative decoding only


class InferenceEngine:
    """Prefill + decode for one model on one device."""

    def __init__(
        self,
        model: MllamaForConditionalGeneration,
        config: MLLAMAConfig,
        device,
        max_cache_length: Optional[int] = None,
        prompt_buckets=None,
        impl: str = "auto",
        kv_dtype: Optional[str] = None,
        spec_lookup: int = 0,
        spec_draft: int = 0,
        draft_params=None,
        draft_config=None,
        gemv_routes="auto",
    ):
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        if spec_lookup or spec_draft or draft_params is not None or draft_config is not None:
            not_in_slice("speculative decoding (spec_lookup / spec_draft)")
        if gemv_routes not in (None, "auto"):
            not_in_slice("gemv_routes (the port has one gemv kernel for every decode linear)")
        if prompt_buckets is not None and prompt_buckets != "auto":
            prompt_buckets = tuple(sorted(int(b) for b in prompt_buckets))
        self.model = model
        self.config = config
        self.device = torch.device(device)
        self.max_cache_length = max_cache_length or config.text_config.max_cache_length
        self.prompt_buckets = prompt_buckets
        self.impl = impl
        self.kv_dtype = kv_dtype

    def generate(
        self,
        input_ids,
        pixel_values=None,
        attention_mask=None,
        max_new_tokens: int = 256,
        temperature: float = 0.0,
        top_p: float = 0.9,
        top_k: int = 50,
        min_p: float = 0.0,
        repetition_penalty: float = 1.0,
        eos_token_id: int = -1,
        rng: Optional[torch.Generator] = None,
    ) -> GenerateResult:
        """Greedy (temperature 0) or sampled generation; sampling draws from
        ``rng``, a ``torch.Generator`` on the engine's device. A
        ``repetition_penalty`` other than 1 penalises every token of the
        prompt (not the image placeholders) and of the generation so far."""
        if not 0.0 <= min_p <= 1.0:
            raise ValueError(f"min_p must be in [0, 1], got {min_p}")
        if repetition_penalty <= 0:
            raise ValueError(f"repetition_penalty must be > 0, got {repetition_penalty}")
        cfg, tc, dev = self.config, self.config.text_config, self.device
        max_len = self.max_cache_length
        with torch.inference_mode():
            ids = torch.as_tensor(input_ids, device=dev).long()
            b, s = ids.shape
            pad = (torch.ones(b, s, dtype=torch.int32, device=dev) if attention_mask is None
                   else torch.as_tensor(attention_mask, device=dev).to(torch.int32))
            s_b = bucketed_len(s, max_new_tokens, max_len, self.prompt_buckets)
            if s_b != s:
                ids = F.pad(ids, (0, s_b - s))
                pad = F.pad(pad, (0, s_b - s))
                s = s_b
            if s + max_new_tokens > max_len:
                raise ValueError(
                    f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds KV cache "
                    f"capacity {max_len}"
                )
            px = None
            if pixel_values is not None:
                px = torch.as_tensor(pixel_values, device=dev).to(tc.torch_dtype)

            cache = init_kv_cache(tc, b, dev, max_length=max_len,
                                  dtype=torch.int8 if self.kv_dtype == "int8" else None)
            true_len = pad.sum(dim=1)
            out = vlm_forward(
                self.model, cfg, input_ids=ids, pixel_values=px,
                attention_mask=structured_prefill_mask(pad, max_len), kv_cache=cache,
                impl=self.impl, logits_positions=(true_len - 1)[:, None],
            )
            pre_logits = out.logits[:, 0]
            pres = None
            if repetition_penalty != 1.0:
                safe_ids = torch.where(ids == cfg.image_token_index, -1, ids)
                pres = presence_from_tokens(safe_ids, true_len, tc.vocab_size)
            sample = dict(rng=rng, temperature=temperature, top_p=top_p, top_k=top_k,
                          min_p=min_p, presence=pres, repetition_penalty=repetition_penalty)
            last = select_next_token(pre_logits, **sample)
            rows = torch.arange(b, device=dev)
            if pres is not None:
                pres[rows, last] = True

            tokens = torch.zeros(b, max_new_tokens, dtype=torch.long, device=dev)
            tokens[:, 0] = last
            done = last == eos_token_id
            count = torch.ones(b, dtype=torch.int32, device=dev)
            eos = torch.full_like(last, eos_token_id)
            for i in range(1, max_new_tokens):
                if bool(done.all()):
                    break
                step = vlm_forward(
                    self.model, cfg, input_ids=last[:, None],
                    attention_mask=structured_decode_mask(pad, s + i, max_len),
                    position_ids=(true_len + (i - 1))[:, None], kv_cache=cache, impl=self.impl,
                )
                nxt = torch.where(done, eos, select_next_token(step.logits[:, -1], **sample))
                if pres is not None:
                    pres[rows, nxt] = pres[rows, nxt] | ~done
                tokens[:, i] = nxt
                count += (~done).to(torch.int32)
                done = done | (nxt == eos_token_id)
                last = nxt
        return GenerateResult(tokens=tokens, num_generated=count, prefill_logits=pre_logits)
