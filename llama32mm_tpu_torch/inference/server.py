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
- deadlines (``timeout_s``), cancellation, a bounded queue (``max_queue``,
  ``QueueFullError``), ``release`` of finished records.

Greedy requests produce the tokens of a solo ``InferenceEngine.generate``
(the tests hold both to the JAX engine). Sampling draws from a
``torch.Generator`` on the server's device.

Not in this slice (``NotImplementedError``, ROADMAP.md queue 1): prefix
caching (``register_prefix`` / ``prefix_id``), per-request LoRA adapters
(``adapter_bank``) and explicit ``gemv_routes``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from llama32mm_tpu_torch.configs import MLLAMAConfig
from llama32mm_tpu_torch.inference.engine import bucketed_len, structured_prefill_mask
from llama32mm_tpu_torch.models.language import llama_forward, lm_head_apply
from llama32mm_tpu_torch.models.vlm import (
    MllamaForConditionalGeneration,
    encode_image,
    merge_input_ids_with_image_features,
    vlm_forward,
)
from llama32mm_tpu_torch.ops.attention import AttnMask
from llama32mm_tpu_torch.ops.dispatch import not_in_slice
from llama32mm_tpu_torch.utils.kvcache import KVCache, init_kv_cache
from llama32mm_tpu_torch.utils.sampling import (
    presence_from_tokens,
    select_next_token_traced,
    spec_verify_tokens,
)


class QueueFullError(RuntimeError):
    """Raised by ``submit`` when the admission queue holds ``max_queue``
    requests (backpressure)."""


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
        "slot", "finished", "prompt_len", "sampler", "deadline", "timed_out",
    )

    def __init__(self, rid, input_ids, pixel_values, max_new_tokens,
                 sampler=(0.0, 0.9, 50, 0.0, 1.0), deadline=None):
        self.rid = rid
        self.input_ids = input_ids  # np [s]
        self.pixel_values = pixel_values  # [3, H, W] (numpy or a tensor) or None
        self.max_new_tokens = max_new_tokens
        self.tokens: list[int] = []
        self.slot: Optional[int] = None
        self.finished = False
        self.prompt_len = int(input_ids.shape[-1])
        self.sampler = sampler  # (T, top_p, top_k, min_p, rep_penalty)
        self.deadline = deadline  # absolute time.monotonic() cutoff or None
        self.timed_out = False


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
        headroom past its budget."""
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if spec_lookup < 0:
            raise ValueError(f"spec_lookup must be >= 0, got {spec_lookup}")
        if adapter_bank is not None:
            not_in_slice("multi-LoRA serving (adapter_bank)")
        if gemv_routes not in (None, "auto"):
            not_in_slice("gemv_routes (the port has one gemv kernel for every decode linear)")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if prompt_buckets is not None and prompt_buckets != "auto":
            prompt_buckets = tuple(sorted(int(b) for b in prompt_buckets))
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
        self._rng = rng if rng is not None else torch.Generator(self.device).manual_seed(0)

        tc, s_max, dev = config.text_config, self.max_cache_length, self.device
        with torch.inference_mode():
            self.state = BatchState(
                cache=init_kv_cache(tc, slots, dev, max_length=s_max,
                                    dtype=torch.int8 if kv_dtype == "int8" else None),
                pos=torch.zeros(slots, dtype=torch.long, device=dev),
                kv_valid=torch.zeros(slots, s_max, dtype=torch.int32, device=dev),
                rope_pos=torch.zeros(slots, dtype=torch.long, device=dev),
                last_token=torch.zeros(slots, dtype=torch.long, device=dev),
                seq=torch.zeros(slots, s_max, dtype=torch.long, device=dev),
                rope_end=torch.zeros(slots, dtype=torch.long, device=dev),
            )
            self._karange = torch.arange(s_max, device=dev)[None, :]
        self._queue: deque[_Request] = deque()
        self._by_slot: list[Optional[_Request]] = [None] * slots
        self._slot_sampler = [self.sampler] * slots
        self._slot_dev = None  # device copies of the occupancy and the samplers
        self._results: dict[int, _Request] = {}
        self._next_id = 0
        self._inflight: Optional[dict] = None  # chunked admission in progress
        self._timeouts = 0
        self._spec_steps = 0  # live-slot verify steps (spec mode)
        self._spec_tokens = 0  # tokens those steps committed that their requests kept

    # -- device-side pieces ---------------------------------------------------

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
            active = self._tensor([r is not None for r in self._by_slot], torch.bool)
            self._slot_dev = (active, self._samp_args(self._slot_sampler))
        return self._slot_dev

    @staticmethod
    def _all_greedy(samplers) -> bool:
        return all(s[0] <= 0.0 for s in samplers)

    @staticmethod
    def _penalised(samplers) -> bool:
        return any(s[4] != 1.0 for s in samplers)

    def _first_token(self, logits, ids_row, true_len: int, sampler) -> torch.Tensor:
        """The request's first token from its prefill logits ``[1, V]``; the
        penalty's context is the prompt (image placeholders excluded)."""
        samp = self._samp_args([sampler])
        pres = penalty = None
        if self._penalised([sampler]):
            safe = torch.where(ids_row == self.config.image_token_index, -1, ids_row)
            pres = presence_from_tokens(safe, self._tensor([true_len], torch.long),
                                        self.config.text_config.vocab_size)
            penalty = samp[4]
        return select_next_token_traced(
            logits, samp[0], samp[1], samp[2], samp[3], presence=pres, penalty=penalty,
            all_greedy=self._all_greedy([sampler]), generator=self._rng)

    def _install(self, req: _Request, slot: int, first: torch.Tensor, ids_row: torch.Tensor,
                 filled: int) -> None:
        """Make ``slot`` live for ``req``: its prompt's ``filled`` cache slots
        are written; the first token is pending at RoPE position
        ``prompt_len``."""
        st, s = self.state, req.prompt_len
        st.pos[slot] = filled
        st.kv_valid[slot] = 0
        st.kv_valid[slot, :s] = 1
        st.rope_pos[slot] = s
        st.rope_end[slot] = s + req.max_new_tokens - 1
        st.last_token[slot:slot + 1] = first
        st.seq[slot] = 0
        st.seq[slot, :s] = ids_row[0, :s]
        st.seq[slot, s:s + 1] = first
        req.slot = slot
        self._by_slot[slot] = req
        self._slot_sampler[slot] = req.sampler
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
        px = None
        if req.pixel_values is not None:
            px = torch.as_tensor(req.pixel_values, device=self.device)
            px = px.to(self.config.text_config.torch_dtype)[None]
        return (torch.as_tensor(ids, device=self.device),
                torch.as_tensor(pad, device=self.device), px)

    def _admit(self, req: _Request, slot: int) -> None:
        """Monolithic admission: one prefill into the slot's view."""
        s = req.prompt_len
        bucket = bucketed_len(s, req.max_new_tokens + self.spec_lookup, self.max_cache_length,
                              self.prompt_buckets)
        ids, pad, px = self._prompt(req, bucket)
        out = vlm_forward(
            self.model, self.config, input_ids=ids, pixel_values=px,
            attention_mask=structured_prefill_mask(pad, self.max_cache_length),
            kv_cache=self.state.cache.slot(slot), impl=self.impl,
            logits_positions=torch.full((1, 1), s - 1, device=self.device),
        )
        first = self._first_token(out.logits[:, 0], ids, s, req.sampler)
        self._install(req, slot, first, ids, bucket)

    def _start_admission(self, req: _Request, slot: int) -> None:
        """Begin a chunked admission: encode the image and embed the prompt
        once; the decoder pass then runs ``prefill_chunk`` tokens per step."""
        s, c = req.prompt_len, self.prefill_chunk
        bucket = -(-s // c) * c
        if bucket > self.max_cache_length - req.max_new_tokens - self.spec_lookup:
            bucket = s  # chunk alignment would overflow: the last chunk runs ragged
        ids, pad, px = self._prompt(req, bucket)
        tc = self.config.text_config
        embeds = self.model.language_model.model.tok_emb[ids.clamp(0, tc.vocab_size - 1)]
        if px is not None:
            feats = encode_image(self.model, self.config, px, impl=self.impl)
            embeds, _ = merge_input_ids_with_image_features(
                feats, embeds, ids, pad, self.config.image_token_index)
        # decode steps between the chunks advance the live slots and write this
        # idle slot at its offset; S-1 is a cache slot the request never uses
        self.state.pos[slot] = self.max_cache_length - 1
        pad_row = torch.zeros(1, self.max_cache_length, dtype=torch.int32, device=self.device)
        pad_row[0, :s] = 1
        self._inflight = {"req": req, "slot": slot, "embeds": embeds, "pad_row": pad_row,
                          "ids": ids, "off": 0, "bucket": bucket, "logits": None}

    def _advance_admission(self) -> None:
        fl = self._inflight
        req, slot, off, bucket = fl["req"], fl["slot"], fl["off"], fl["bucket"]
        n = min(self.prefill_chunk, bucket - off)
        view = self.state.cache.slot(slot)
        view.pos = off
        lm = self.model.language_model
        out = llama_forward(
            lm.model, self.config.text_config, input_embeds=fl["embeds"][:, off:off + n],
            attention_mask=AttnMask(kv_valid=fl["pad_row"], q_offset=off),
            position_ids=(off + torch.arange(n, device=self.device))[None],
            kv_cache=view, impl=self.impl,
        )
        last = req.prompt_len - 1
        if off <= last < off + n:  # the chunk holding the prompt's last token
            h_last = out.hidden_states[:, last - off:last - off + 1]
            fl["logits"] = lm_head_apply(lm, self.config.text_config, h_last, impl=self.impl)[:, 0]
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
        all_greedy = self._all_greedy(self._slot_sampler)
        penalised = self._penalised(self._slot_sampler)
        image_id, vocab = self.config.image_token_index, self.config.text_config.vocab_size
        cache, karange, eos = st.cache, self._karange, self.eos_token_id
        jr = torch.arange(k + 1, device=self.device)
        # tokens [B, n, T] and, in the last column, the counts: one copy back
        out_buf = torch.empty(self.slots, n, k + 2, dtype=torch.long, device=self.device)
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
                impl=self.impl,
            )
            pres = None
            if penalised:
                pres = presence_from_tokens(torch.where(seq == image_id, -1, seq), rp + 1, vocab)
            penalty = samp[4] if penalised else None
            budget = torch.where(active, st.rope_end - rp, 0)  # tokens a slot may still commit
            if k:
                nxt, acc_bit = spec_verify_tokens(
                    out.logits, drafts, self._rng, samp[0], samp[1], samp[2], samp[3],
                    presence=pres, penalty=penalty, all_greedy=all_greedy)
                n_commit = torch.cumprod(acc_bit.long(), dim=1).sum(dim=1) + 1
                eos_hit = (jr < n_commit[:, None]) & (nxt == eos)
                n_commit = torch.minimum(n_commit, torch.where(eos_hit, jr, k + 1).amin(dim=1) + 1)
                n_commit = torch.minimum(n_commit, budget)
            else:
                nxt = select_next_token_traced(
                    out.logits[:, -1], samp[0], samp[1], samp[2], samp[3], presence=pres,
                    penalty=penalty, all_greedy=all_greedy, generator=self._rng)[:, None]
                n_commit = budget.clamp(0, 1)
            self._commit(nxt, n_commit, wp)
            out_buf[:, i, :k + 1] = nxt
            out_buf[:, i, k + 1] = n_commit
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

    def register_prefix(self, input_ids, pixel_values=None, auto_match=None,
                        adapter_id: int = 0) -> int:
        not_in_slice("prefix caching (register_prefix)")

    def _check_adapter_id(self, adapter_id: int) -> None:
        if adapter_id != 0:
            raise ValueError("no adapter_bank configured on this server")

    def _match_prefix(self, ids: np.ndarray, adapter_id: int):
        return None  # no prefixes without register_prefix

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
        """Queue one request (``input_ids`` ``[s]`` or ``[1, s]``); returns its
        id. The sampler arguments override the server's defaults for this
        request. ``timeout_s``: a request still queued or decoding that long
        after submission is finished at the next ``step()`` with the tokens it
        has, flagged ``timed_out``."""
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            raise QueueFullError(f"admission queue full ({len(self._queue)}/{self.max_queue})")
        if timeout_s is not None and timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        if prefix_id is not None:
            not_in_slice("prefix caching (prefix_id)")
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
        rid = self._next_id
        self._next_id += 1
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        req = _Request(rid, ids, px, max_new_tokens, sampler=sampler, deadline=deadline)
        self._queue.append(req)
        self._results[rid] = req
        return rid

    def _expire_deadlines(self) -> None:
        now = time.monotonic()
        expired = [r for r in self._results.values()
                   if not r.finished and r.deadline is not None and now >= r.deadline]
        for req in expired:
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
        self._slot_dev = (torch.zeros(self.slots, dtype=torch.bool, device=self.device),
                          self._samp_args(self._slot_sampler))
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
            **({"spec_lookup": self.spec_lookup,
                "spec_tokens_per_step": round(self._spec_tokens / max(self._spec_steps, 1), 3)}
               if self.spec_lookup else {}),
            **({"admitting": self._inflight["req"].rid,
                "admit_progress": f"{self._inflight['off']}/{self._inflight['bucket']}"}
               if self._inflight is not None else {}),
        }
