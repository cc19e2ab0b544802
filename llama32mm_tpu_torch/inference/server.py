"""Continuous-batching server over a fixed pool of KV-cache slots
(counterpart of ``llama32mm_tpu/inference/server.py``).

- a **fixed pool of B slots**: one batch KV cache ``[L, B, n_kv, S, hd]``
  with a write offset, a RoPE position, a validity row and a token history
  per slot;
- **admission = prefill into the slot**: the request's prompt (and image)
  is prefilled straight into its slot's one-row view of the batch cache, in
  place (``KVCache.slot``), where the JAX package prefills a scratch cache and
  splices it into the batch; with ``prefill_chunk=C`` the decoder pass runs
  ``C`` tokens per ``step()`` at ``q_offset = off`` into that view, with a
  decode chunk for the running slots in between (the image tower encodes in
  one go);
- **decode** advances every slot each step, inactive slots masked (their
  writes land in their own rows, which the next admission resets), so every
  step has the same shapes; per-slot write offsets go to the cache as a
  ``[B]`` vector and to the flash kernel as per-row query offsets, per-slot
  RoPE positions to the rotary embedding;
- **per-request samplers** (temperature, top-p, top-k, min-p, repetition
  penalty), per-slot ``[B]`` tensors rebuilt only when a slot changes hands;
  whether every slot is greedy, and whether any is penalised, is known on the
  host, so a step never reads the device to decide it;
- ``steps_per_sync`` decode steps per chunk, the chunk length quantized to a
  power of two (the JAX package's ladder, kept so that ``step()`` emits and
  ``stats()`` counts as there): the sampled tokens stay on the device for
  the whole chunk, and one device-to-host copy per chunk brings them back;
- **speculative decoding** (``spec_lookup=K``): every live slot drafts K
  tokens by the trailing-bigram lookup over its own token history, one
  (K+1)-token forward over the pool verifies them, and each slot commits its
  longest accepted prefix plus one token (``utils/sampling.py::
  spec_verify_tokens``: greedy slots exact, sampled slots distributed as
  without speculation). The mask stays structured: a slot's valid keys plus
  its K+1 new slots ``wp..wp+K``, query offset ``wp``, causal; every
  committed key lies below ``wp``, so this is the JAX package's dense mask
  exactly;
- **prefix caching** (``register_prefix``): the K/V of a shared prompt
  prefix (an image and its instruction template, a system preamble) is
  computed once and kept for its ``P`` positions only (``[L, 1, n_kv, P,
  hd]``, the int8 scales with them); an admission that uses it copies those
  rows into its slot, marks them valid and prefills only the suffix from
  ``q_offset = P`` through the chunked-admission code, so its cost follows
  the suffix. ``drop_prefix`` frees the rows;
- **multi-LoRA serving** (``adapter_bank``, ``train/lora.py::
  stack_adapter_bank``): each request picks an adapter by ``adapter_id``;
  admission runs that adapter (the bank indexed at one id, the shared
  ``[L, in, r]`` layout) and every decode step runs each slot's own adapter
  in the one batched forward (``models/language.py::maybe_lora``'s per-row
  branch over the bank gathered by slot, rebuilt only when a slot's adapter
  changes). Adapters on ``w_gate`` / ``w_up`` put the FFN on its unfused
  ``silu(gate) * up`` form, so such a bank launches no SwiGLU kernel. A
  bank's projector adapter applies to the image of a monolithic admission
  only, as in the JAX package (chunked and prefixed admissions and image
  prefixes encode with the base projector); vision adapters are not
  per-slot;
- deadlines (``timeout_s``), cancellation, a bounded queue (``max_queue``,
  ``QueueFullError``), ``release`` of finished records.

Tensor parallelism (a model from ``parallel/sharding.py::shard_params``):
every rank of the mesh runs this same host loop on the same requests (SPMD)
and keeps the whole pool's host state; the all-gathered logits are the same
bits on every rank and the generators are seeded alike, so every rank draws
the same tokens. A deadline expires on every rank as soon as it has on one
(an all-reduce of the expired flags over the whole mesh), so the ranks'
clocks cannot split the loop. Each rank's cache holds its kv heads. An
adapter bank stays whole on every rank, and each adapted linear takes its
shard's slice of the adapter (``models/language.py::maybe_lora``).

With ``dp > 1`` on the mesh, data-parallel group ``g`` owns slots ``[g·B/dp,
(g+1)·B/dp)`` and holds the device state of those rows only. Every rank runs
the same scheduler decisions; an admission runs on the owning group, which
hands the first token to the others (an all-reduce over ``dp``); a decode
chunk runs on each group's rows and its tokens are all-gathered over ``dp``
at the chunk's one device-to-host copy. Samplers draw at the whole pool's
shape and each group takes its rows, so the tokens are those of the server
at ``dp = 1`` under the same generator. Registered prefixes are computed and
held by every group.

Greedy requests produce the tokens of a solo ``InferenceEngine.generate``
on the full prompt, with a bank adapter those of an engine on the model
with that adapter merged (the tests hold both to the JAX package).
Sampling draws from a ``torch.Generator`` on the server's device.
Explicit ``gemv_routes`` are refused (ROADMAP.md, "Do not port").
"""

from __future__ import annotations

import time
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from llama32mm_tpu_torch.configs import MLLAMAConfig
from llama32mm_tpu_torch.inference.engine import bucketed_len, structured_prefill_mask
from llama32mm_tpu_torch.models.language import embed_tokens, llama_forward, lm_head_apply
from llama32mm_tpu_torch.models.vlm import (
    MllamaForConditionalGeneration,
    encode_image,
    merge_input_ids_with_image_features,
    vlm_forward,
)
from llama32mm_tpu_torch.ops.attention import AttnMask
from llama32mm_tpu_torch.ops.dispatch import not_in_slice
from llama32mm_tpu_torch.parallel.mesh import AXIS_DP, AXIS_TP
from llama32mm_tpu_torch.parallel.sharding import tp_of
from llama32mm_tpu_torch.train.lora import first_leaf, gather_adapter_bank
from llama32mm_tpu_torch.utils.kvcache import KVCache, init_kv_cache
from llama32mm_tpu_torch.utils.sampling import (
    presence_from_tokens,
    select_next_token_traced,
    spec_verify_tokens,
)


class QueueFullError(RuntimeError):
    """Raised by ``submit`` when the admission queue holds ``max_queue``
    requests (backpressure; the HTTP front end answers 429)."""


def _single_adapter(bank: dict, aid: int) -> dict:
    """Adapter ``aid`` of a bank in the shared layout (``[L, in, r]``
    blocks, ``[in, r]`` flat leaves): views of the bank's rows, no copy."""
    return {k: _single_adapter(v, aid) if isinstance(v, dict) else v[aid] for k, v in bank.items()}


class BatchState(NamedTuple):
    """The slot pool on the device; the tensors are updated in place."""

    cache: KVCache  # k/v (and int8 scales) of every slot; its pos is unused
    pos: torch.Tensor  # [B] int64: per-slot write offset (cache coordinates)
    kv_valid: torch.Tensor  # [B, S] int32: attendable cache positions per slot
    rope_pos: torch.Tensor  # [B] int64: RoPE position of the pending token
    last_token: torch.Tensor  # [B] int64: the token fed next step
    seq: torch.Tensor  # [B, S] int64: prompt + generated tokens at their true
    # positions (seq[b, rope_pos[b]] == last_token[b]); the penalty's context
    rope_end: torch.Tensor  # [B] int64: RoPE position of the request's last token
    # (prompt + budget - 1), where its slot stops committing


class _Request:
    __slots__ = (
        "rid", "input_ids", "pixel_values", "max_new_tokens", "tokens",
        "slot", "finished", "prompt_len", "prefix", "adapter_id", "sampler",
        "deadline", "timed_out",
    )

    def __init__(self, rid, input_ids, pixel_values, max_new_tokens, prefix=None,
                 adapter_id=0, sampler=(0.0, 0.9, 50, 0.0, 1.0), deadline=None):
        self.rid = rid
        self.input_ids = input_ids  # np [s]
        self.pixel_values = pixel_values  # [3, H, W] (numpy or a tensor) or None
        self.max_new_tokens = max_new_tokens
        self.tokens: list[int] = []
        self.slot: Optional[int] = None
        self.finished = False
        self.prompt_len = int(input_ids.shape[-1])
        self.prefix: Optional[_Prefix] = prefix
        self.adapter_id = adapter_id
        self.sampler = sampler  # (T, top_p, top_k, min_p, rep_penalty)
        self.deadline = deadline  # absolute time.monotonic() cutoff or None
        self.timed_out = False


class _Prefix:
    """A registered prompt prefix: the K/V of its ``P`` positions (``cache``,
    ``[L, 1, n_kv, P, hd]``, with the int8 scales in that mode), computed once
    with adapter ``adapter_id``; ``cache`` is None once dropped and no queued
    request needs it."""

    __slots__ = ("pid", "input_ids", "has_image", "auto_match", "cache", "length", "hits",
                 "adapter_id")

    def __init__(self, pid, input_ids, has_image, auto_match, cache, adapter_id):
        self.pid = pid
        self.input_ids = input_ids  # np [P]
        self.has_image = has_image
        self.auto_match = auto_match
        self.cache: Optional[KVCache] = cache
        self.length = int(input_ids.shape[0])
        self.hits = 0
        self.adapter_id = adapter_id


class ContinuousBatchingServer:
    """Slot-pool scheduler: submit requests any time, step the batch, collect
    finished generations.

    The sampler settings given here are per-request defaults, overridden per
    ``submit``; ``max_new_tokens`` is per request. ``prompt_buckets`` as in
    ``InferenceEngine`` (``"auto"`` pads a prompt to the next multiple of
    128). ``device`` is where the model lives and the server runs.
    """

    def __init__(
        self,
        model: MllamaForConditionalGeneration,
        config: MLLAMAConfig,
        device,
        slots: int = 4,
        max_cache_length: Optional[int] = None,
        kv_dtype: Optional[str] = None,
        prompt_buckets="auto",
        impl: str = "auto",
        temperature: float = 0.0,
        top_p: float = 0.9,
        top_k: int = 50,
        min_p: float = 0.0,
        repetition_penalty: float = 1.0,
        eos_token_id: int = -1,
        steps_per_sync: int = 8,
        prefill_chunk: Optional[int] = None,
        spec_lookup: int = 0,
        adapter_bank: Optional[dict] = None,
        rng: Optional[torch.Generator] = None,
        max_queue: Optional[int] = None,
        gemv_routes="auto",
    ):
        """``prefill_chunk=C``: chunked admission, ``C`` prompt tokens per
        ``step()``, token for token the same as monolithic admission.
        ``spec_lookup=K``: prompt-lookup speculative decoding, each decode
        step a (K+1)-token verify; a request then needs K cache slots of
        headroom past its budget. ``adapter_bank``: a stacked bank of LoRA
        adapters (``train/lora.py::stack_adapter_bank``, leaves ``[N,
        ...]``), picked per request by ``submit(..., adapter_id=i)``; entry 0
        is conventionally the identity adapter (``zero_lora_params``), so
        that default requests run the base model."""
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if spec_lookup < 0:
            raise ValueError(f"spec_lookup must be >= 0, got {spec_lookup}")
        if gemv_routes not in (None, "auto"):
            not_in_slice("gemv_routes (the port has one gemv kernel for every decode linear)")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if prompt_buckets is not None and prompt_buckets != "auto":
            prompt_buckets = tuple(sorted(int(b) for b in prompt_buckets))
        self.tp = tp_of(model)
        self.dp = 1 if self.tp is None else self.tp.mesh.shape[AXIS_DP]
        if slots % self.dp:
            raise ValueError(f"slots={slots} do not split over dp={self.dp}")
        rows = slots // self.dp  # this data-parallel group's slots
        self._row0 = 0 if self.tp is None else self.tp.mesh.rank(AXIS_DP) * rows
        self._rows = slice(self._row0, self._row0 + rows)
        self.model = model
        self.config = config
        self.device = torch.device(device)
        self.slots = slots
        self.max_cache_length = max_cache_length or config.text_config.max_cache_length
        self.kv_dtype = kv_dtype
        self.prompt_buckets = prompt_buckets
        self.impl = impl
        self.sampler = (temperature, top_p, top_k, min_p, repetition_penalty)
        self.eos_token_id = eos_token_id
        self.steps_per_sync = steps_per_sync
        self.prefill_chunk = prefill_chunk
        self.max_queue = max_queue
        self.spec_lookup = int(spec_lookup)
        self.adapter_bank = adapter_bank
        self.n_adapters = int(first_leaf(adapter_bank).shape[0]) if adapter_bank is not None else 0
        self._rng = rng if rng is not None else torch.Generator(self.device).manual_seed(0)

        s_max, dev = self.max_cache_length, self.device
        with torch.inference_mode():
            self.state = BatchState(
                cache=self._new_cache(rows),
                pos=torch.zeros(rows, dtype=torch.long, device=dev),
                kv_valid=torch.zeros(rows, s_max, dtype=torch.int32, device=dev),
                rope_pos=torch.zeros(rows, dtype=torch.long, device=dev),
                last_token=torch.zeros(rows, dtype=torch.long, device=dev),
                seq=torch.zeros(rows, s_max, dtype=torch.long, device=dev),
                rope_end=torch.zeros(rows, dtype=torch.long, device=dev),
            )
            self._karange = torch.arange(s_max, device=dev)[None, :]
        self._queue: deque[_Request] = deque()
        self._by_slot: list[Optional[_Request]] = [None] * slots
        self._slot_sampler = [self.sampler] * slots
        self._slot_adapter = [0] * slots  # adapter id per slot (bank mode)
        self._slot_dev = None  # device copies of the occupancy and the samplers
        self._slot_bank = None  # (adapter ids, the bank gathered by slot)
        self._prefixes: dict[int, _Prefix] = {}
        self._next_prefix_id = 0
        self._results: dict[int, _Request] = {}
        self._next_id = 0
        self._inflight: Optional[dict] = None  # chunked admission in progress
        self._timeouts = 0
        self._spec_steps = 0  # live-slot verify steps (spec mode)
        self._spec_tokens = 0  # tokens those steps committed that their requests kept

    # -- device-side pieces ---------------------------------------------------

    def _new_cache(self, rows: int) -> KVCache:
        """A cache of ``rows`` slots in the server's dtype (this rank's kv
        heads under TP)."""
        return init_kv_cache(self.config.text_config, rows, self.device,
                             max_length=self.max_cache_length,
                             dtype=torch.int8 if self.kv_dtype == "int8" else None,
                             n_kv_heads=None if self.tp is None else self.tp.kv_heads)

    def _local(self, slot: int) -> Optional[int]:
        """``slot``'s row in this group's device state, or None when another
        data-parallel group owns it."""
        row = slot - self._row0
        return row if 0 <= row < self.state.pos.shape[0] else None

    def _tensor(self, values, dtype) -> torch.Tensor:
        return torch.tensor(values, dtype=dtype, device=self.device)

    def _samp_args(self, samplers) -> tuple:
        """(T, top_p, top_k, min_p, penalty) of each sampler as [n] tensors."""
        cols = list(zip(*samplers))
        f, i = torch.float32, torch.long
        return tuple(self._tensor(list(c), d) for c, d in zip(cols, (f, f, i, f, f)))

    def _slot_args(self):
        """``(active [B] bool, sampler tensors)`` for decode, rebuilt only when a
        slot changes hands (a host-to-device copy, outside any decode chunk)."""
        if self._slot_dev is None:
            active = self._tensor([r is not None for r in self._by_slot[self._rows]], torch.bool)
            self._slot_dev = (active, self._samp_args(self._slot_sampler[self._rows]))
        return self._slot_dev

    @staticmethod
    def _all_greedy(samplers) -> bool:
        return all(s[0] <= 0.0 for s in samplers)

    @staticmethod
    def _penalised(samplers) -> bool:
        return any(s[4] != 1.0 for s in samplers)

    def _first_token(self, logits, ids_row, true_len: int, sampler) -> torch.Tensor:
        """The request's first token ``[1]`` from its prefill logits ``[1,
        V]`` (None on the data-parallel groups that do not own its slot);
        the penalty's context is the prompt (image placeholders excluded)."""
        vocab = self.config.text_config.vocab_size
        greedy = self._all_greedy([sampler])
        # every group draws, so that the generators stay in step
        uniforms = None if greedy else torch.rand(1, vocab, generator=self._rng,
                                                  device=self.device)
        if logits is None:  # another group's slot: its token arrives below
            first = torch.zeros(1, dtype=torch.long, device=self.device)
        else:
            samp = self._samp_args([sampler])
            pres = penalty = None
            if self._penalised([sampler]):
                safe = torch.where(ids_row == self.config.image_token_index, -1, ids_row)
                pres = presence_from_tokens(safe, self._tensor([true_len], torch.long), vocab)
                penalty = samp[4]
            first = select_next_token_traced(
                logits, samp[0], samp[1], samp[2], samp[3], presence=pres, penalty=penalty,
                all_greedy=greedy, uniforms=uniforms)
        if self.dp > 1:  # the owning group's token, summed with the others' zeros
            first = self.tp.mesh.all_reduce(first, AXIS_DP)
        return first

    def _adapter(self, adapter_id: int) -> Optional[dict]:
        """The request's adapter for its admission (None without a bank)."""
        if self.adapter_bank is None:
            return None
        return _single_adapter(self.adapter_bank, adapter_id)

    def _slot_lora(self) -> Optional[dict]:
        """Each slot's adapter for decode: the bank's decoder and head
        adapters gathered by slot (``[L, B, in, r]`` blocks, ``[B, in, r]``
        head), gathered again only when a slot's adapter id changes."""
        if self.adapter_bank is None:
            return None
        ids = tuple(self._slot_adapter[self._rows])
        if self._slot_bank is None or self._slot_bank[0] != ids:
            self._slot_bank = None  # free the old gather before the new one
            bank = {k: v for k, v in self.adapter_bank.items() if k in ("blocks", "lm_head")}
            self._slot_bank = (ids, gather_adapter_bank(bank, self._tensor(list(ids), torch.long)))
        return self._slot_bank[1]

    def _install(self, req: _Request, slot: int, first: torch.Tensor, ids_row: torch.Tensor,
                 filled: int) -> None:
        """Make ``slot`` live for ``req``: its prompt's ``filled`` cache slots
        are written; the first token is pending at RoPE position
        ``prompt_len``. The device state changes on the owning group only."""
        st, s, row = self.state, req.prompt_len, self._local(slot)
        if row is not None:
            st.pos[row] = filled
            st.kv_valid[row] = 0
            st.kv_valid[row, :s] = 1
            st.rope_pos[row] = s
            st.rope_end[row] = s + req.max_new_tokens - 1
            st.last_token[row:row + 1] = first
            st.seq[row] = 0
            st.seq[row, :s] = ids_row[0, :s]
            st.seq[row, s:s + 1] = first
        req.slot = slot
        self._by_slot[slot] = req
        self._slot_sampler[slot] = req.sampler
        self._slot_adapter[slot] = req.adapter_id
        self._slot_dev = None
        req.input_ids = req.pixel_values = None  # the prompt lives in the cache now
        self._emit(req, [int(first[0])])  # one device read per admission

    def _prompt(self, req: _Request, bucket: int):
        """The prompt padded to ``bucket``: ``(ids [1, bucket], pad [1,
        bucket], pixel values [1, 3, H, W] or None)`` on the device."""
        s = req.prompt_len
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :s] = req.input_ids
        pad = np.zeros((1, bucket), np.int32)
        pad[0, :s] = 1
        return (torch.as_tensor(ids, device=self.device),
                torch.as_tensor(pad, device=self.device), self._pixels(req.pixel_values))

    def _pixels(self, px) -> Optional[torch.Tensor]:
        """Pixel values ``[3, H, W]`` (numpy or a tensor) as ``[1, 3, H, W]``
        on the device in the model's dtype."""
        if px is None:
            return None
        return torch.as_tensor(px, device=self.device).to(self.config.text_config.torch_dtype)[None]

    def _embed(self, ids: torch.Tensor, pad: torch.Tensor, px) -> torch.Tensor:
        """Token embeddings ``[1, n, H]`` of ``ids`` with the image's features
        spliced over its ``<image>`` ids (the decoder applies its scale)."""
        lm = self.model.language_model
        embeds = embed_tokens(lm.model, self.config.text_config, ids)
        if px is not None:
            feats = encode_image(self.model, self.config, px, impl=self.impl)
            embeds, _ = merge_input_ids_with_image_features(
                feats, embeds, ids, pad, self.config.image_token_index)
        return embeds

    def _prefill_rows(self, embeds: torch.Tensor, pad_row: torch.Tensor, off: int,
                      view: KVCache, lora: Optional[dict]):
        """The decoder over ``embeds`` (prompt positions ``off..off+n-1``)
        into the one-row cache ``view`` at ``q_offset = off``; ``pad_row [1,
        S]`` marks the prompt's keys."""
        n = embeds.shape[1]
        view.pos = off
        return llama_forward(
            self.model.language_model.model, self.config.text_config, input_embeds=embeds,
            attention_mask=AttnMask(kv_valid=pad_row, q_offset=off),
            position_ids=(off + torch.arange(n, device=self.device))[None],
            kv_cache=view, impl=self.impl, lora=lora,
        )

    def _admit(self, req: _Request, slot: int) -> None:
        """Monolithic admission: one prefill into the slot's view; a prefixed
        request prefills its suffix through the chunked-admission code,
        within this call."""
        if req.prefix is not None:
            self._start_admission(req, slot)
            while self._inflight is not None:
                self._advance_admission()
            return
        s = req.prompt_len
        bucket = bucketed_len(s, req.max_new_tokens + self.spec_lookup, self.max_cache_length,
                              self.prompt_buckets)
        ids = logits = None
        row = self._local(slot)
        if row is not None:
            ids, pad, px = self._prompt(req, bucket)
            out = vlm_forward(
                self.model, self.config, input_ids=ids, pixel_values=px,
                attention_mask=structured_prefill_mask(pad, self.max_cache_length),
                kv_cache=self.state.cache.slot(row), impl=self.impl,
                logits_positions=torch.full((1, 1), s - 1, device=self.device),
                lora=self._adapter(req.adapter_id),
            )
            logits = out.logits[:, 0]
        first = self._first_token(logits, ids, s, req.sampler)
        self._install(req, slot, first, ids, bucket)

    def _start_admission(self, req: _Request, slot: int) -> None:
        """Begin a chunked or prefixed admission: encode the image and embed
        the prompt (a prefixed request: copy the prefix's rows into the slot
        and embed the suffix) once; the decoder pass then runs one chunk per
        ``_advance_admission`` from ``off = P`` (0 without a prefix). The
        chunk is ``prefill_chunk``; without it, a prefixed admission's suffix
        is one chunk, rounded up to 128 rows under ``"auto"`` buckets."""
        s, pfx = req.prompt_len, req.prefix
        base = 0 if pfx is None else pfx.length
        n_suffix = s - base
        if self.prefill_chunk is not None:
            c = self.prefill_chunk
        elif self.prompt_buckets == "auto":
            c = -(-n_suffix // 128) * 128
        else:
            c = n_suffix
        bucket = base + -(-n_suffix // c) * c
        if bucket > self.max_cache_length - req.max_new_tokens - self.spec_lookup:
            bucket = s  # chunk alignment would overflow: the last chunk runs ragged
        self._inflight = {"req": req, "slot": slot, "embeds": None, "pad_row": None,
                          "ids": None, "off": base, "base": base, "chunk": c, "bucket": bucket,
                          "lora": self._adapter(req.adapter_id), "logits": None}
        row = self._local(slot)
        if row is not None:  # the owning group prefills; the others follow the offsets
            ids, pad, px = self._prompt(req, bucket)
            embeds = self._embed(ids[:, base:], pad[:, base:], px)
            if pfx is not None:
                view, src = self.state.cache.slot(row), pfx.cache
                view.k[:, :, :, :base].copy_(src.k)
                view.v[:, :, :, :base].copy_(src.v)
                if view.quantized:
                    view.k_scale[..., :base].copy_(src.k_scale)
                    view.v_scale[..., :base].copy_(src.v_scale)
            # decode steps between the chunks advance the live slots and write
            # this idle slot at its offset; S-1 is a cache slot the request never uses
            self.state.pos[row] = self.max_cache_length - 1
            pad_row = torch.zeros(1, self.max_cache_length, dtype=torch.int32,
                                  device=self.device)
            pad_row[0, :s] = 1
            self._inflight.update(embeds=embeds, pad_row=pad_row, ids=ids)
        if pfx is not None:
            pfx.hits += 1
            self._release_if_dropped(pfx)

    def _advance_admission(self) -> None:
        fl = self._inflight
        req, slot, off, bucket, base = fl["req"], fl["slot"], fl["off"], fl["bucket"], fl["base"]
        n = min(fl["chunk"], bucket - off)
        lora = fl["lora"]
        if fl["embeds"] is not None:  # the owning group
            out = self._prefill_rows(fl["embeds"][:, off - base:off - base + n], fl["pad_row"],
                                     off, self.state.cache.slot(self._local(slot)), lora)
            last = req.prompt_len - 1
            if off <= last < off + n:  # the chunk holding the prompt's last token
                h_last = out.hidden_states[:, last - off:last - off + 1]
                fl["logits"] = lm_head_apply(
                    self.model.language_model, self.config.text_config, h_last,
                    impl=self.impl, lora=None if lora is None else lora.get("lm_head"))[:, 0]
        fl["off"] = off + n
        if fl["off"] >= bucket:
            self._inflight = None
            first = self._first_token(fl["logits"], fl["ids"], req.prompt_len, req.sampler)
            self._install(req, slot, first, fl["ids"], bucket)

    @torch.inference_mode()
    def _decode(self, n: int):
        """``n`` decode steps of every slot: ``(tokens [B, n, T], counts [B,
        n])`` in one device-to-host copy, step ``i`` having committed the
        first ``counts[b, i]`` of slot ``b``'s ``T`` tokens.

        Without speculation T = 1: each slot feeds its pending token at its
        write offset ``wp = pos`` (clamped, so an idle slot writes its own
        row) and commits the token sampled after it. With ``spec_lookup=K``
        a step is a verify step, T = K+1: a slot drafts the K tokens that
        followed the latest earlier occurrence of its trailing bigram in
        ``seq``; the pool's (K+1)-token forward writes slot ``b``'s entries at
        ``wp..wp+K`` (``wp`` clamped to ``S-1-K``); each slot commits its
        accepted prefix plus one token, cut at the first eos. Entries past
        the commit stay masked until a later step overwrites them. Every
        commit stops at the request's budget (``rope_end``) and idle slots
        commit nothing (``_commit``)."""
        st, s_max, k = self.state, self.max_cache_length, self.spec_lookup
        active, samp = self._slot_args()
        lora = self._slot_lora()
        all_greedy = self._all_greedy(self._slot_sampler)
        penalised = self._penalised(self._slot_sampler)
        image_id, vocab = self.config.image_token_index, self.config.text_config.vocab_size
        cache, karange, eos = st.cache, self._karange, self.eos_token_id
        jr = torch.arange(k + 1, device=self.device)
        rows = (self._row0, self.slots)  # this group's rows of the pool
        # tokens [B, n, T] and, in the last column, the counts: one copy back
        out_buf = torch.empty(st.pos.shape[0], n, k + 2, dtype=torch.long, device=self.device)
        for i in range(n):
            seq, rp, last = st.seq, st.rope_pos, st.last_token
            ids = last[:, None]
            if k:
                m = ((seq == seq.gather(1, (rp - 1).clamp(0, s_max - 1)[:, None]))
                     & (seq.roll(-1, dims=1) == last[:, None]) & (karange + 1 < rp[:, None]))
                start = (torch.where(m, karange, -1).amax(dim=1) + 2).clamp(0, s_max - k)
                drafts = seq.gather(1, start[:, None] + jr[None, :k])
                ids = torch.cat([ids, drafts], dim=1)
            wp = st.pos.clamp(0, s_max - 1 - k)
            attend = ((st.kv_valid != 0) | ((karange >= wp[:, None])
                                             & (karange <= wp[:, None] + k))).to(torch.int32)
            out = vlm_forward(
                self.model, self.config, input_ids=ids,
                attention_mask=AttnMask(kv_valid=attend, q_offset=wp.to(torch.int32)),
                position_ids=rp[:, None] + jr,
                kv_cache=KVCache(cache.k, cache.v, wp, cache.k_scale, cache.v_scale),
                impl=self.impl, lora=lora,
            )
            pres = None
            if penalised:
                pres = presence_from_tokens(torch.where(seq == image_id, -1, seq), rp + 1, vocab)
            penalty = samp[4] if penalised else None
            budget = torch.where(active, st.rope_end - rp, 0)  # tokens a slot may still commit
            if k:
                nxt, acc_bit = spec_verify_tokens(
                    out.logits, drafts, self._rng, samp[0], samp[1], samp[2], samp[3],
                    presence=pres, penalty=penalty, all_greedy=all_greedy, rows=rows)
                n_commit = torch.cumprod(acc_bit.long(), dim=1).sum(dim=1) + 1
                eos_hit = (jr < n_commit[:, None]) & (nxt == eos)
                n_commit = torch.minimum(n_commit, torch.where(eos_hit, jr, k + 1).amin(dim=1) + 1)
                n_commit = torch.minimum(n_commit, budget)
            else:
                uniforms = None  # drawn for the whole pool, this group's rows taken
                if not all_greedy:
                    uniforms = torch.rand(self.slots, vocab, generator=self._rng,
                                          device=self.device)[self._rows]
                nxt = select_next_token_traced(
                    out.logits[:, -1], samp[0], samp[1], samp[2], samp[3], presence=pres,
                    penalty=penalty, all_greedy=all_greedy, uniforms=uniforms)[:, None]
                n_commit = budget.clamp(0, 1)
            self._commit(nxt, n_commit, wp)
            out_buf[:, i, :k + 1] = nxt
            out_buf[:, i, k + 1] = n_commit
        if self.dp > 1:  # every group's rows, at the chunk's one copy back
            out_buf = self.tp.mesh.all_gather(out_buf, AXIS_DP, dim=0)
        host = out_buf.cpu().numpy()
        return host[:, :, :k + 1], host[:, :, k + 1]

    def _commit(self, nxt: torch.Tensor, n_commit: torch.Tensor, wp: torch.Tensor) -> None:
        """Advance slot ``b`` by the first ``n_commit[b]`` of its tokens ``nxt
        [B, T]``, whose inputs' cache entries this step wrote from ``wp[b]``:
        those entries become valid, the tokens join ``seq`` after the pending
        one, the write offset and the RoPE position move on, and the last
        committed token is the next one fed. A slot with ``n_commit`` 0 (idle,
        or its budget spent) keeps its state, so no RoPE position passes the
        request's ``rope_end`` and every ``seq`` index stays inside the
        cache."""
        st, karange = self.state, self._karange
        moved = n_commit > 0
        st.kv_valid.logical_or_((karange >= wp[:, None]) & (karange < (wp + n_commit)[:, None]))
        off = karange - (st.rope_pos + 1)[:, None]
        torch.where((off >= 0) & (off < n_commit[:, None]),
                    nxt.gather(1, off.clamp(0, nxt.shape[1] - 1)), st.seq, out=st.seq)
        torch.where(moved, wp + n_commit, st.pos, out=st.pos)
        st.rope_pos.add_(n_commit)
        torch.where(moved, nxt.gather(1, (n_commit - 1).clamp(min=0)[:, None])[:, 0],
                    st.last_token, out=st.last_token)

    # -- host-side scheduling -------------------------------------------------

    @torch.inference_mode()
    def register_prefix(self, input_ids, pixel_values=None, auto_match=None,
                        adapter_id: int = 0) -> int:
        """Compute and keep the K/V of a shared prompt prefix (an image and its
        instruction template, a system preamble, few-shot examples); requests
        whose prompt starts with it skip its prefill: admission copies its
        rows into the slot and prefills only the suffix.

        ``auto_match`` (default: true for a text-only prefix) lets ``submit``
        use the prefix by the longest token-prefix match. A prefix with an
        image is never auto-matched (every image request starts with the same
        ``<image>`` ids); pass its ``prefix_id`` to ``submit``, with
        ``pixel_values=None``: the image is in the prefix. The prefix's K/V
        are computed with adapter ``adapter_id`` and serve only requests of
        that adapter. Cost: the ``P`` positions' K/V, kept on the device."""
        ids = np.asarray(input_ids.cpu() if isinstance(input_ids, torch.Tensor) else input_ids)
        ids = ids.reshape(-1).astype(np.int64)
        p = int(ids.shape[0])
        if p < 1 or p >= self.max_cache_length:
            raise ValueError(f"prefix length {p} must be in [1, cache {self.max_cache_length})")
        px = pixel_values
        if px is not None and px.ndim == 4:
            px = px[0]
        use_image = px is not None
        if auto_match is None:
            auto_match = not use_image
        if auto_match and use_image:
            raise ValueError("image prefixes cannot be auto-matched — pass prefix_id explicitly")
        self._check_adapter_id(adapter_id)
        # one prefill of the P positions into a one-row scratch cache shaped
        # like a slot (the admission's shapes), of which the P rows are kept
        scratch = self._new_cache(1)
        ids_t = torch.as_tensor(ids, device=self.device)[None]
        pad_row = torch.zeros(1, self.max_cache_length, dtype=torch.int32, device=self.device)
        pad_row[0, :p] = 1
        embeds = self._embed(ids_t, pad_row[:, :p], self._pixels(px))
        self._prefill_rows(embeds, pad_row, 0, scratch, self._adapter(adapter_id))
        scales = ((scratch.k_scale[..., :p].clone(), scratch.v_scale[..., :p].clone())
                  if scratch.quantized else (None, None))
        cache = KVCache(scratch.k[:, :, :, :p].clone(), scratch.v[:, :, :, :p].clone(), p, *scales)
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = _Prefix(pid, ids, use_image, auto_match, cache, adapter_id)
        return pid

    def drop_prefix(self, prefix_id: int) -> None:
        """Unregister a prefix and free its K/V (after the admission of a
        queued request that uses it, if there is one)."""
        self._release_if_dropped(self._prefixes.pop(prefix_id))

    def _release_if_dropped(self, pfx: _Prefix) -> None:
        if self._prefixes.get(pfx.pid) is not pfx and not any(r.prefix is pfx
                                                              for r in self._queue):
            pfx.cache = None

    def _check_adapter_id(self, adapter_id: int) -> None:
        if adapter_id == 0 and self.adapter_bank is None:
            return
        if self.adapter_bank is None:
            raise ValueError("no adapter_bank configured on this server")
        if not 0 <= adapter_id < self.n_adapters:
            raise ValueError(f"adapter_id {adapter_id} out of range [0, {self.n_adapters})")

    def _match_prefix(self, ids: np.ndarray, adapter_id: int) -> Optional[_Prefix]:
        """The longest auto-match prefix of ``ids`` computed with the same
        adapter (a prefix's K/V are adapter-specific)."""
        best = None
        for p in self._prefixes.values():
            if (p.auto_match and p.adapter_id == adapter_id and p.length < ids.shape[0]
                    and (best is None or p.length > best.length)
                    and np.array_equal(ids[:p.length], p.input_ids)):
                best = p
        return best

    def submit(
        self,
        input_ids,
        pixel_values=None,
        max_new_tokens: int = 256,
        prefix_id: Optional[int] = None,
        adapter_id: int = 0,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        top_k: Optional[int] = None,
        min_p: Optional[float] = None,
        repetition_penalty: Optional[float] = None,
        timeout_s: Optional[float] = None,
    ) -> int:
        """Queue one request (``input_ids`` ``[s]`` or ``[1, s]``: the full
        prompt, a prefix's tokens included); returns its id. ``prefix_id``
        pins a registered prefix; without it a text-only request uses the
        longest registered auto-match prefix of the same ``adapter_id``.
        ``adapter_id`` picks the request's adapter from ``adapter_bank``. The
        sampler arguments override the server's defaults for this request.
        ``timeout_s``: a request still queued or decoding that long after
        submission is finished at the next ``step()`` with the tokens it has,
        flagged ``timed_out``."""
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            raise QueueFullError(f"admission queue full ({len(self._queue)}/{self.max_queue})")
        if timeout_s is not None and timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        sampler = (
            self.sampler[0] if temperature is None else float(temperature),
            self.sampler[1] if top_p is None else float(top_p),
            self.sampler[2] if top_k is None else int(top_k),
            self.sampler[3] if min_p is None else float(min_p),
            self.sampler[4] if repetition_penalty is None else float(repetition_penalty),
        )
        if sampler[4] <= 0:
            raise ValueError(f"repetition_penalty must be > 0, got {sampler[4]}")
        if not 0.0 <= sampler[3] <= 1.0:
            # min_p > 1 puts the threshold above the argmax and masks every token
            raise ValueError(f"min_p must be in [0, 1], got {sampler[3]}")
        ids = np.asarray(input_ids.cpu() if isinstance(input_ids, torch.Tensor) else input_ids)
        if ids.ndim == 2 and ids.shape[0] == 1:
            ids = ids[0]
        if ids.ndim != 1:
            raise ValueError(
                f"submit() takes ONE prompt ([s] or [1, s]); got shape {ids.shape} — call "
                "submit once per request")
        # refused now: failing at admission would strand the request mid-step;
        # speculation needs K slots of headroom (the last verify writes K+1)
        if ids.shape[0] + max_new_tokens + self.spec_lookup > self.max_cache_length:
            extra = f" + spec headroom ({self.spec_lookup})" if self.spec_lookup else ""
            raise ValueError(
                f"prompt ({ids.shape[0]}) + max_new_tokens ({max_new_tokens}){extra} exceeds "
                f"cache capacity {self.max_cache_length}")
        px = pixel_values
        if px is not None and px.ndim == 4:
            px = px[0]
        self._check_adapter_id(adapter_id)
        prefix = None
        if prefix_id is not None:
            prefix = self._prefixes[prefix_id]
            if prefix.length >= ids.shape[0]:
                raise ValueError(f"prompt ({ids.shape[0]}) must extend past the prefix "
                                 f"({prefix.length}) by at least one token")
            if not np.array_equal(ids[:prefix.length], prefix.input_ids):
                raise ValueError("prompt does not start with the given prefix's tokens")
            if prefix.has_image and px is not None:
                raise ValueError(
                    "the prefix already carries the image — submit with pixel_values=None")
            if prefix.adapter_id != adapter_id:
                raise ValueError(
                    f"prefix {prefix_id} was computed with adapter {prefix.adapter_id}, not "
                    f"{adapter_id} — prefix KV is adapter-specific")
        elif px is None:
            prefix = self._match_prefix(ids, adapter_id)
        rid = self._next_id
        self._next_id += 1
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        req = _Request(rid, ids, px, max_new_tokens, prefix=prefix, adapter_id=adapter_id,
                       sampler=sampler, deadline=deadline)
        self._queue.append(req)
        self._results[rid] = req
        return rid

    def _expire_deadlines(self) -> None:
        now = time.monotonic()
        timed = [r for r in self._results.values() if not r.finished and r.deadline is not None]
        expired = [now >= r.deadline for r in timed]
        if self.tp is not None and timed:
            # each rank reads its own clock: a request expires on every rank
            # once it has on one, so the ranks admit and decode the same slots
            flags = torch.tensor(expired, dtype=torch.int32, device=self.device)
            for axis in (AXIS_TP, AXIS_DP):
                self.tp.mesh.all_reduce(flags, axis)
            expired = flags.gt(0).tolist()
        for req in [r for r, e in zip(timed, expired) if e]:
            req.timed_out = True
            self._timeouts += 1
            self.cancel(req.rid)

    def _emit(self, req: _Request, toks: list) -> None:
        for t in toks:
            if req.finished:
                break
            req.tokens.append(t)
            if t == self.eos_token_id or len(req.tokens) >= req.max_new_tokens:
                req.finished = True
        if req.finished and req.slot is not None:
            self._free_slot(req)

    def release(self, rid: int) -> bool:
        """Evict a finished request's record; False (record kept) while it is
        queued or running — ``cancel`` those."""
        req = self._results.get(rid)
        if req is None:
            return True
        if not req.finished:
            return False
        del self._results[rid]
        return True

    def _free_slot(self, req: _Request) -> None:
        self._by_slot[req.slot] = None
        # back to greedy (full 5-tuple): a stale temperature > 0 would keep the
        # whole batch off the all-greedy path while the slot sits idle
        self._slot_sampler[req.slot] = (0.0, self.sampler[1], self.sampler[2], 0.0, 1.0)
        self._slot_dev = None
        req.slot = None

    @torch.inference_mode()
    def step(self) -> list:
        """Admit pending requests into free slots (one prefill chunk when
        ``prefill_chunk`` is set), then run one decode chunk for the running
        slots. Returns the ids of requests that finished during this call."""
        before = {r.rid for r in self._results.values() if r.finished}
        self._expire_deadlines()

        if self.prefill_chunk is not None:
            if self._inflight is not None:
                self._advance_admission()
            elif self._queue:
                for slot in range(self.slots):
                    if self._by_slot[slot] is None:
                        self._start_admission(self._queue.popleft(), slot)
                        self._advance_admission()  # first chunk this step
                        break
        else:
            for slot in range(self.slots):
                if self._by_slot[slot] is None and self._queue:
                    self._admit(self._queue.popleft(), slot)

        live = [r for r in self._by_slot if r is not None]
        if live:
            # the tightest budget bounds the chunk, quantized (_chunk_steps);
            # tokens past a request's budget or eos are dropped by _emit
            remaining = min(r.max_new_tokens - len(r.tokens) for r in live)
            # a verify step commits 1 to K+1 tokens a slot
            toks, counts = self._decode(self._chunk_steps(-(-remaining // (self.spec_lookup + 1))))
            for slot, req in enumerate(self._by_slot):
                # emitted step by step, so that the acceptance statistic
                # counts only the tokens a request keeps
                for i in range(toks.shape[1] if req is not None else 0):
                    if req.finished:
                        break
                    kept = len(req.tokens)
                    self._emit(req, toks[slot, i, :counts[slot, i]].tolist())
                    self._spec_steps += 1
                    self._spec_tokens += len(req.tokens) - kept

        after = {r.rid for r in self._results.values() if r.finished}
        return sorted(after - before)

    def _chunk_steps(self, needed: int) -> int:
        """The decode chunk: a power of two, at most ``steps_per_sync``."""
        n = 1
        while n < min(needed, self.steps_per_sync):
            n *= 2
        return min(n, max(1, self.steps_per_sync))

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run every chunk length of the ladder once with every slot inactive
        (a no-op for the slots: inactive slots advance nothing, and their
        writes land where the next step or admission writes again)."""
        self._slot_dev = (torch.zeros(self.state.pos.shape[0], dtype=torch.bool,
                                      device=self.device),
                          self._samp_args(self._slot_sampler[self._rows]))
        n = 1
        while True:
            self._decode(self._chunk_steps(n))
            if n >= self.steps_per_sync:
                break
            n *= 2
        self._slot_dev = None

    def run(self) -> dict:
        """Step until every submitted request finishes; ``{id: token ids}``."""
        while self._queue or self._inflight is not None or any(
                r is not None for r in self._by_slot):
            self.step()
        return {rid: np.asarray(r.tokens) for rid, r in self._results.items()}

    def cancel(self, rid: int) -> bool:
        """Dequeue a request or free its slot (its cache row needs no cleanup:
        admission resets it); a chunked admission in progress is abandoned.
        False if the request already finished."""
        req = self._results[rid]
        if req.finished:
            return False
        req.finished = True
        if req.slot is not None:
            self._free_slot(req)
        elif self._inflight is not None and self._inflight["req"] is req:
            self._inflight = None
        else:
            try:
                self._queue.remove(req)
            except ValueError:
                pass
            if req.prefix is not None:
                self._release_if_dropped(req.prefix)
        return True

    def tokens_so_far(self, rid: int) -> np.ndarray:
        return np.asarray(self._results[rid].tokens)

    def is_finished(self, rid: int) -> bool:
        return self._results[rid].finished

    def stats(self) -> dict:
        """Occupancy, queue depth, progress."""
        live = [r for r in self._by_slot if r is not None]
        return {
            "slots": self.slots,
            "slots_busy": len(live),
            "queued": len(self._queue),
            "submitted": self._next_id,
            "finished": sum(r.finished for r in self._results.values()),
            "tokens_generated": sum(len(r.tokens) for r in self._results.values()),
            **({"max_queue": self.max_queue} if self.max_queue is not None else {}),
            **({"timeouts": self._timeouts} if self._timeouts else {}),
            **({"prefixes": len(self._prefixes),
                "prefix_hits": sum(p.hits for p in self._prefixes.values()),
                "prefix_tokens_cached": sum(p.length for p in self._prefixes.values())}
               if self._prefixes else {}),
            **({"adapters": self.n_adapters} if self.adapter_bank is not None else {}),
            **({"spec_lookup": self.spec_lookup,
                "spec_tokens_per_step": round(self._spec_tokens / max(self._spec_steps, 1), 3)}
               if self.spec_lookup else {}),
            **({"admitting": self._inflight["req"].rid,
                "admit_progress": f"{self._inflight['off']}/{self._inflight['bucket']}"}
               if self._inflight is not None else {}),
        }
