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

Speculative decoding (batch 1), as in the JAX engine: ``spec_lookup=K``
drafts K tokens by the trailing-bigram lookup over the prompt and the
generated tokens, ``spec_draft=K`` by K greedy steps of a small draft
``CausalLM`` with its own KV cache; one (K+1)-row forward of the target at
cache slots ``p..p+K`` then verifies them (``utils/sampling.py::
spec_verify_tokens``), and the longest accepted prefix plus one token is
committed. The lookup, the draft steps and the commit all stay on the
device: the loop's one blocking read a verify step is the flag that says
whether to go on, as the plain loop's ``done``.

Tensor parallelism (a model from ``parallel/sharding.py::shard_params``):
every rank of a ``tp`` group runs this loop on the same inputs; the
all-gathered logits are the same bits on every rank and samplers seeded
alike draw alike, so every rank produces the same tokens. With ``dp > 1`` on
the mesh each dp group serves its share of the batch rows and the results
are all-gathered over ``dp``. A speculation draft is whole on every rank (a
``CausalLM`` without a ``TPShard``) or sharded on the same mesh; either way
every rank runs the same draft steps on the same tokens, so every rank
proposes and commits the same tokens.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from llama32mm_tpu_torch.configs import MLLAMAConfig
from llama32mm_tpu_torch.models.language import CausalLM, causal_lm_forward, llama_forward
from llama32mm_tpu_torch.models.vlm import MllamaForConditionalGeneration, vlm_forward
from llama32mm_tpu_torch.ops.attention import AttnMask
from llama32mm_tpu_torch.ops.dispatch import not_in_slice
from llama32mm_tpu_torch.parallel.mesh import AXIS_DP
from llama32mm_tpu_torch.parallel.sharding import tp_of
from llama32mm_tpu_torch.utils.kvcache import KVCache, init_kv_cache
from llama32mm_tpu_torch.utils.sampling import (
    presence_from_tokens,
    select_next_token,
    spec_verify_tokens,
)


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


def build_prefill_mask(padding_mask: torch.Tensor, max_len: int,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The dense form of ``structured_prefill_mask`` (the JAX package's
    ``build_prefill_mask``): ``[B, S]`` padding mask → ``[B, 1, S, max_len]``
    additive mask, causal over the first S key slots, padding and the cache
    tail blocked."""
    s = padding_mask.shape[1]
    dev = padding_mask.device
    q = torch.arange(s, device=dev)[:, None]
    k = torch.arange(max_len, device=dev)[None, :]
    key_pad_ok = F.pad(padding_mask.bool(), (0, max_len - s))
    ok = ((k <= q) & (k < s))[None] & key_pad_ok[:, None, :]
    return torch.where(ok[:, None], torch.zeros((), dtype=dtype, device=dev),
                       torch.tensor(torch.finfo(dtype).min, dtype=dtype, device=dev))


def build_decode_mask(padding_mask: torch.Tensor, cur_len, max_len: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The dense form of ``structured_decode_mask`` (the JAX package's
    ``build_decode_mask``): ``[B, 1, 1, max_len]``, the prompt's padding
    blocked, the slots below ``cur_len`` attendable, the tail blocked."""
    s = padding_mask.shape[1]
    dev = padding_mask.device
    k = torch.arange(max_len, device=dev)[None, :]
    key_pad_ok = F.pad(padding_mask.bool(), (0, max_len - s))
    ok = (k < cur_len) & torch.where(k < s, key_pad_ok, True)
    return torch.where(ok[:, None, None, :], torch.zeros((), dtype=dtype, device=dev),
                       torch.tensor(torch.finfo(dtype).min, dtype=dtype, device=dev))


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
    steps: Optional[torch.Tensor] = None  # speculative decoding only: verify steps taken


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
        draft_params: Optional[CausalLM] = None,
        draft_config=None,
        gemv_routes="auto",
    ):
        """``spec_lookup=K`` (K >= 1): prompt-lookup speculative decoding.
        ``spec_draft=K`` with ``draft_params`` (a ``CausalLM`` whose
        vocabulary covers the target's; ``convert.py::causal_lm_from_jax``
        builds one from a JAX tree) and ``draft_config`` (its
        ``LLAMA32Config``): draft-model speculative decoding; the draft sees
        the token ids only (image placeholders fed id 0). Both run batch 1,
        greedy or sampled; greedy tokens equal the plain loop's."""
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        if gemv_routes not in (None, "auto"):
            not_in_slice("gemv_routes (the port has one gemv kernel for every decode linear)")
        if spec_lookup < 0:
            raise ValueError(f"spec_lookup must be >= 0, got {spec_lookup}")
        if spec_draft < 0:
            raise ValueError(f"spec_draft must be >= 0, got {spec_draft}")
        if spec_draft and spec_lookup:
            raise ValueError("spec_draft and spec_lookup are mutually exclusive")
        if spec_draft and (draft_params is None or draft_config is None):
            raise ValueError("spec_draft needs draft_params and draft_config")
        if spec_draft and not isinstance(draft_params, CausalLM):
            raise TypeError("draft_params must be a CausalLM (convert.py::causal_lm_from_jax "
                            "converts a JAX parameter tree)")
        if spec_draft and draft_config.vocab_size < config.text_config.vocab_size:
            raise ValueError(
                "draft vocab must cover the target vocab: "
                f"{draft_config.vocab_size} < {config.text_config.vocab_size}"
            )
        if prompt_buckets is not None and prompt_buckets != "auto":
            prompt_buckets = tuple(sorted(int(b) for b in prompt_buckets))
        self.tp = tp_of(model)
        dtp = tp_of(draft_params) if spec_draft else None
        if dtp is not None and (self.tp is None or dtp.mesh is not self.tp.mesh):
            raise ValueError("a sharded draft must be sharded on the target's mesh")
        self.model = model
        self.config = config
        self.device = torch.device(device)
        self.max_cache_length = max_cache_length or config.text_config.max_cache_length
        self.prompt_buckets = prompt_buckets
        self.impl = impl
        self.kv_dtype = kv_dtype
        self.spec_lookup = int(spec_lookup)
        self.spec_draft = int(spec_draft)
        self.draft_params = draft_params
        self.draft_config = draft_config

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
        prompt (not the image placeholders) and of the generation so far.
        On a mesh with ``dp > 1`` this rank's dp group generates its share of
        the rows (B must divide by dp) and every rank returns all rows."""
        mesh = None if self.tp is None else self.tp.mesh
        dp = 1 if mesh is None else mesh.shape[AXIS_DP]
        args = dict(max_new_tokens=max_new_tokens, temperature=temperature, top_p=top_p,
                    top_k=top_k, min_p=min_p, repetition_penalty=repetition_penalty,
                    eos_token_id=eos_token_id, rng=rng)
        if dp == 1:
            return self._generate(input_ids, pixel_values, attention_mask, **args)
        ids = torch.as_tensor(input_ids)
        b = ids.shape[0]
        if b % dp:
            raise ValueError(f"batch {b} does not split over dp={dp}")
        share = b // dp
        rows = slice(mesh.rank(AXIS_DP) * share, (mesh.rank(AXIS_DP) + 1) * share)

        def mine(x):
            return None if x is None else torch.as_tensor(x)[rows]

        res = self._generate(ids[rows], mine(pixel_values), mine(attention_mask), **args)
        return GenerateResult(*(None if t is None else mesh.all_gather(t, AXIS_DP, dim=0)
                                for t in res))

    def _generate(self, input_ids, pixel_values, attention_mask, max_new_tokens: int,
                  temperature: float, top_p: float, top_k: int, min_p: float,
                  repetition_penalty: float, eos_token_id: int,
                  rng: Optional[torch.Generator]) -> GenerateResult:
        if not 0.0 <= min_p <= 1.0:
            raise ValueError(f"min_p must be in [0, 1], got {min_p}")
        if repetition_penalty <= 0:
            raise ValueError(f"repetition_penalty must be > 0, got {repetition_penalty}")
        cfg, tc, dev = self.config, self.config.text_config, self.device
        max_len = self.max_cache_length
        spec_k = self.spec_lookup or self.spec_draft
        with torch.inference_mode():
            ids = torch.as_tensor(input_ids, device=dev).long()
            b, s = ids.shape
            pad = (torch.ones(b, s, dtype=torch.int32, device=dev) if attention_mask is None
                   else torch.as_tensor(attention_mask, device=dev).to(torch.int32))
            # speculation reserves K slots past the budget: the last verify writes K+1
            s_b = bucketed_len(s, max_new_tokens + spec_k, max_len, self.prompt_buckets)
            if s_b != s:
                ids = F.pad(ids, (0, s_b - s))
                pad = F.pad(pad, (0, s_b - s))
                s = s_b
            if s + max_new_tokens > max_len:
                raise ValueError(
                    f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds KV cache "
                    f"capacity {max_len}"
                )
            if spec_k:
                if b != 1:
                    which = "spec" if self.spec_lookup else "specd"
                    raise ValueError(f"{which} decoding supports batch size 1")
                if s + max_new_tokens + spec_k > max_len:
                    raise ValueError(
                        f"speculative K={spec_k} needs K extra cache slots: "
                        f"prompt ({s}) + max_new_tokens ({max_new_tokens}) + K > "
                        f"capacity {max_len}"
                    )
            px = None
            if pixel_values is not None:
                px = torch.as_tensor(pixel_values, device=dev).to(tc.torch_dtype)

            cache = init_kv_cache(tc, b, dev, max_length=max_len,
                                  dtype=torch.int8 if self.kv_dtype == "int8" else None,
                                  n_kv_heads=None if self.tp is None else self.tp.kv_heads)
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
            if spec_k:
                sampler = (temperature, top_p, top_k, min_p, repetition_penalty)
                tokens, count, steps = self._spec_loop(ids, pad, cache, true_len, last, pres,
                                                       max_new_tokens, eos_token_id, sampler, rng)
                return GenerateResult(tokens=tokens, num_generated=count,
                                      prefill_logits=pre_logits, steps=steps)

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

    def decode_tokens(self, tokenizer, result: GenerateResult, batch_idx: int = 0) -> str:
        """Row ``batch_idx``'s generated tokens as text (special tokens skipped)."""
        toks = result.tokens[batch_idx][: int(result.num_generated[batch_idx])]
        return tokenizer.decode(toks.tolist(), skip_special_tokens=True).strip()

    def _spec_loop(self, ids, pad, cache, true_len, first, pres, max_new_tokens: int,
                   eos_token_id: int, sampler: tuple, rng):
        """The speculative decode loop (batch 1) after the prefill; returns
        ``(tokens [1, max_new_tokens], num_generated [1], steps)``.

        A verify step feeds the last committed token and K drafts at cache
        slots ``p..p+K`` (``p = s + count - 1``, a per-row cache offset and
        query offset on the device) and RoPE positions ``tl + count - 1 + j``;
        entries past the accepted prefix stay masked by ``kv_valid`` until the
        next step overwrites them. It commits the longest accepted draft
        prefix plus one token, clamped to the budget and cut at the first
        eos. Nothing in the step reads the device but the loop's condition."""
        cfg, dev = self.config, self.device
        k = self.spec_lookup or self.spec_draft
        max_len, vocab = self.max_cache_length, cfg.text_config.vocab_size
        s = ids.shape[1]
        tl = true_len.long()  # [1]
        jr = torch.arange(k + 1, device=dev)
        k_arr = torch.arange(max_len, device=dev)[None, :]
        pad_ok = F.pad(pad.bool(), (0, max_len - s), value=True)
        tidx = torch.arange(max_new_tokens, device=dev)
        samp = tuple(torch.tensor([v], dtype=d, device=dev) for v, d in zip(
            sampler, (torch.float32, torch.float32, torch.long, torch.float32, torch.float32)))
        all_greedy = sampler[0] <= 0.0
        if pres is not None:  # column `vocab` takes the tokens a step does not commit
            pres = F.pad(pres, (0, 1))

        tokens = torch.zeros(1, max_new_tokens, dtype=torch.long, device=dev)
        tokens[:, 0] = first
        done = first == eos_token_id
        count = torch.ones(1, dtype=torch.long, device=dev)
        if self.spec_lookup:
            # the true sequence: the prompt at [0, tl), then the generated
            # tokens, with no bucket gap (unlike the cache slots)
            seq_len = s + max_new_tokens
            idx = torch.arange(seq_len, device=dev)
            seq = torch.where(idx < tl, F.pad(ids[0], (0, max_new_tokens)), 0)
            seq.scatter_(0, tl, first)
        else:
            dtc, dtp = self.draft_config, tp_of(self.draft_params)
            dcache = init_kv_cache(dtc, 1, dev, max_length=max_len, dtype=dtc.torch_dtype,
                                   n_kv_heads=None if dtp is None else dtp.kv_heads)
            llama_forward(self.draft_params.model, dtc,
                          input_ids=torch.where(ids == cfg.image_token_index, 0, ids),
                          attention_mask=structured_prefill_mask(pad, max_len),
                          kv_cache=dcache, impl=self.impl)
            last = first
        steps = 0
        while bool(((count < max_new_tokens) & ~done).all()):
            p_slot = s + count - 1  # [1]
            rope0 = tl + count - 1
            if self.spec_lookup:
                # the K tokens that followed the latest earlier occurrence of
                # the trailing bigram; no match drafts tokens that get rejected
                last = seq.gather(0, rope0)
                m = ((seq == seq.gather(0, rope0 - 1)) & (seq.roll(-1) == last)
                     & (idx + 1 < rope0))
                start = (torch.where(m, idx, -1).amax() + 2).clamp(0, seq_len - k)
                drafts = seq.gather(0, start + jr[:k])
            else:
                drafts = self._draft(dcache, last, p_slot, rope0, k_arr, pad_ok)
            kv_valid = ((k_arr < p_slot + k + 1) & pad_ok).to(torch.int32)
            out = vlm_forward(
                self.model, cfg, input_ids=torch.cat([last, drafts])[None],
                attention_mask=AttnMask(kv_valid=kv_valid, q_offset=p_slot.to(torch.int32)),
                position_ids=(rope0 + jr)[None],
                kv_cache=KVCache(cache.k, cache.v, p_slot, cache.k_scale, cache.v_scale),
                impl=self.impl,
            )
            nxt, acc_bit = spec_verify_tokens(
                out.logits, drafts[None], rng, *samp[:4],
                presence=None if pres is None else pres[:, :vocab],
                penalty=None if pres is None else samp[4], all_greedy=all_greedy)
            nxt = nxt[0]
            n_commit = torch.minimum(torch.cumprod(acc_bit[0].long(), 0).sum() + 1,
                                     max_new_tokens - count)
            eos_hit = (jr < n_commit) & (nxt == eos_token_id)
            n_commit = torch.minimum(n_commit, torch.where(eos_hit, jr, k + 1).amin() + 1)
            if pres is not None:
                pres[0].scatter_(0, torch.where(jr < n_commit, nxt, vocab), True)
            sel = (tidx >= count) & (tidx < count + n_commit)
            tokens[0] = torch.where(sel, nxt.gather(0, (tidx - count).clamp(0, k)), tokens[0])
            if self.spec_lookup:
                off = idx - (tl + count)
                seq = torch.where((off >= 0) & (off < n_commit), nxt.gather(0, off.clamp(0, k)),
                                  seq)
            else:
                last = nxt.gather(0, n_commit - 1)
            done = done | eos_hit.any()
            count = count + n_commit
            steps += 1
        return tokens, count.to(torch.int32), torch.tensor(steps, dtype=torch.int32)

    def _draft(self, dcache, last, p_slot, rope0, k_arr, pad_ok) -> torch.Tensor:
        """K greedy steps of the draft model from ``last`` (``[1]``), writing
        its cache at slots ``p_slot + j``; returns the drafts ``[K]``. A
        (K+1)-th step only writes slot ``p_slot + K`` (no head): a fully
        accepted verify commits K+1 tokens, and without that entry every
        later draft would attend an unwritten slot."""
        draft, dtc, k = self.draft_params, self.draft_config, self.spec_draft
        drafts, cur = [], last
        for j in range(k + 1):
            slot = p_slot + j
            kw = dict(input_ids=cur[None],
                      attention_mask=AttnMask(kv_valid=((k_arr <= slot) & pad_ok).to(torch.int32),
                                              q_offset=slot.to(torch.int32)),
                      position_ids=(rope0 + j)[None], kv_cache=KVCache(dcache.k, dcache.v, slot),
                      impl=self.impl)
            if j == k:
                llama_forward(draft.model, dtc, **kw)
                break
            logits, _ = causal_lm_forward(draft, dtc, **kw)
            cur = torch.argmax(logits[:, -1], dim=-1)
            drafts.append(cur)
        return torch.cat(drafts)
