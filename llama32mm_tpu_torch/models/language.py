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
  ``silu(gate) * up`` form instead of the fused SwiGLU, as in JAX;
- LoRA (``lora``, the JAX package's adapter tree: per target
  ``lora_a [L, in, r]``, ``lora_b [L, r, out]``, ``scaling [L]``):
  ``base + scaling * (dropout(x) @ A) @ B`` with A and B cast to x's dtype;
  a bank gathered by row (``train/lora.py::gather_adapter_bank``: ``[L, B,
  in, r]``, ``[L, B, r, out]``, ``[L, B]``, the head's ``[B, ...]``) gives
  each batch row its own adapter, as two ``torch.bmm`` (multi-LoRA
  serving); adapters on gate or up also take the explicit form (``silu(g +
  dg) * (u + du)`` is not a delta on the fused output), so such a model
  launches no SwiGLU kernel;
- ``remat=True``: each block under ``torch.utils.checkpoint`` (the JAX
  package's ``jax.checkpoint`` of the scanned layer body);
- ``collect_stats=True``: each layer's fp32 mean |x| over (batch, positions)
  of norm1's output, norm2's output and the SwiGLU output (the inputs of
  q/k/v, gate/up and w_down), stacked ``[L, h]``, ``[L, h]``, ``[L, I]`` in
  ``LlamaOutput.stats``: the calibration signal of ``ops/awq.py``;
- the attention mask: a 2D ``[B, S]`` padding mask or an ``AttnMask``
  (the structured form every kernel takes), or a dense additive ``[B, 1,
  Tq, Tk]`` mask, which passes through to the plain dense attention;
- tensor parallelism (``parallel/sharding.py::shard_params``): a decoder
  with a ``TPShard`` holds its rank's heads, FFN columns and vocabulary
  rows; each block sums ``attn_out`` over ``tp`` after ``out_proj`` (before
  ``norm2`` reads it) and ``ff_out`` after ``w_down`` (Megatron's ``g``),
  the embedding sums the rows its rank looked up, and the head all-gathers
  the vocab-sharded logits, so every rank holds the full ``[B, T, V]``. The
  inputs of the column-parallel linears (norm1's and norm2's outputs, the
  head's) pass through ``f``, whose backward sums their partial gradients,
  so the residual stream's gradient and the norms' are whole on every rank
  (``parallel/mesh.py``). A replicated adapter is sliced to the rank's
  shard: ``lora_b``'s output columns on a column-parallel linear (the
  head's vocabulary too), ``lora_a``'s input rows on a row-parallel one,
  whose partial delta joins the partial product before the sum. Dropout
  masks are drawn at the one-device shape and sliced the same way (and to
  the rank's batch rows under ``dp``), so a sharded step equals the
  one-device step. ``collect_stats`` gathers ``inter_absmean`` over ``tp``
  and averages every statistic over ``dp``. Without a ``TPShard`` (``tp``
  None) no collective is called;
- sequence parallelism (a mesh with ``sp > 1``, each rank given its
  contiguous token chunk, ``parallel/sharding.py::seq_data_sharding``):
  RoPE's positions and the causal ``q_offset`` start at ``sp_rank * T_loc``,
  attention runs the ring over ``sp`` (``ops/attention.py``) with the
  rank's key-validity chunk riding with its K/V, dropout masks are drawn
  at the one-device shape and the rank's tokens taken, and
  ``collect_stats`` averages over ``dp`` and ``sp``. Everything else runs
  on the local tokens as it is. A KV cache holds whole sequences: it is
  not taken under ``sp``;
- a pipeline stage (``parallel/pipeline.py``) holds only its layers and
  runs through the pipeline's schedule, never ``llama_forward``.

One module per layer (no ``[L, ...]`` stacks). Float linears with at most 32
input rows run the decode gemv kernel, others (and every linear under
autograd) a plain matmul (``ops/gemv.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from llama32mm_tpu_torch.configs import LLAMA32Config
from llama32mm_tpu_torch.models.common import Linear, Norm, empty_param
from llama32mm_tpu_torch.ops.attention import AttnMask, gqa_attention
from llama32mm_tpu_torch.ops.dispatch import not_in_slice
from llama32mm_tpu_torch.ops.gemv import linear
from llama32mm_tpu_torch.ops.quant import is_quantized
from llama32mm_tpu_torch.ops.rmsnorm import fused_add_rmsnorm
from llama32mm_tpu_torch.ops.rope import apply_rotary_pos_emb, rope_cos_sin
from llama32mm_tpu_torch.ops.swiglu import fused_swiglu
from llama32mm_tpu_torch.parallel.mesh import AXIS_DP, AXIS_SP, AXIS_TP
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
    tp = None  # a TPShard on a rank of a tensor-parallel mesh (parallel/sharding.py)
    stage = None  # a PipelineStage on a pipeline stage's rank (parallel/pipeline.py)

    def __init__(self, config: LLAMA32Config, device, dtype):
        super().__init__()
        self.config = config
        self.tok_emb = empty_param(config.vocab_size, config.hidden_size, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(DecoderBlock(config, device, dtype) for _ in range(config.n_layers))
        self.final_norm = Norm(config.hidden_size, False, device, dtype)

    def init_(self, gen: torch.Generator) -> None:
        """The JAX package's ``init_llama_params`` distributions."""
        self.tok_emb.normal_(generator=gen)
        if self.config.pad_token_index is not None:
            self.tok_emb[self.config.pad_token_index] = 0.0
        for mod in self.modules():
            if isinstance(mod, Linear):
                mod.init_(gen)
            elif isinstance(mod, Norm):
                mod.init_()

    def forward(self, input_ids=None, input_embeds=None, attention_mask=None, position_ids=None,
                kv_cache=None, impl: str = "auto", **kwargs) -> "LlamaOutput":
        """``llama_forward`` (other keywords pass through to it)."""
        return llama_forward(self, self.config, input_ids=input_ids, input_embeds=input_embeds,
                             attention_mask=attention_mask, position_ids=position_ids,
                             kv_cache=kv_cache, impl=impl, **kwargs)


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
        self.model.init_(gen)
        if self.lm_head is not None:
            self.lm_head.init_(gen)

    def forward(self, input_ids=None, input_embeds=None, attention_mask=None, position_ids=None,
                kv_cache=None, impl: str = "auto"):
        """``causal_lm_forward``: ``(logits, kv_cache)``."""
        return causal_lm_forward(self, self.config, input_ids=input_ids,
                                 input_embeds=input_embeds, attention_mask=attention_mask,
                                 position_ids=position_ids, kv_cache=kv_cache, impl=impl)


def init_llama_params(config: LLAMA32Config, device, gen: torch.Generator,
                      dtype: Optional[torch.dtype] = None) -> LlamaModel:
    """A random-init decoder with the JAX package's ``init_llama_params``
    distributions, drawn from ``gen`` (a generator on ``device``)."""
    model = LlamaModel(config, device, dtype or config.torch_dtype)
    with torch.no_grad():
        model.init_(gen)
    return model


def init_causal_lm_params(config: LLAMA32Config, device, gen: torch.Generator,
                          tie_weights: bool = True,
                          dtype: Optional[torch.dtype] = None) -> CausalLM:
    """A random-init decoder and head (the JAX package's
    ``init_causal_lm_params``); a tied head reads the embedding."""
    lm = CausalLM(config, device, dtype or config.torch_dtype, tie_weights)
    with torch.no_grad():
        lm.init_(gen)
    return lm


def prepare_attention_mask(attention_mask: Optional[torch.Tensor], batch: int, seq_len: int,
                           dtype: torch.dtype, device) -> torch.Tensor:
    """The reference's ``_prepare_attention_mask`` (the JAX package's
    ``prepare_attention_mask``): a 4D mask passes through; a 2D padding mask
    (None: all ones) becomes the dense additive ``[B, 1, T, T]`` mask, an
    upper-triangular ``-inf`` causal term plus ``(1 - mask) · finfo.min``
    on padded keys."""
    if attention_mask is not None and attention_mask.dim() == 4:
        return attention_mask.to(dtype)
    if attention_mask is None:
        base = torch.ones(batch, seq_len, dtype=dtype, device=device)
    elif attention_mask.dim() == 2:
        base = attention_mask.to(dtype)
    else:
        raise ValueError("attention_mask must be 2D or 4D")
    causal = torch.full((seq_len, seq_len), float("-inf"), dtype=dtype, device=base.device)
    causal = causal.triu(1)[None, None].expand(batch, 1, seq_len, seq_len)
    padding = ((1.0 - base) * torch.finfo(dtype).min)[:, None, None, :]
    return causal + padding


def prepare_position_ids(position_ids: Optional[torch.Tensor], batch: int, seq_len: int,
                         device) -> torch.Tensor:
    """``position_ids`` as given, or ``0..seq_len-1`` for every row."""
    if position_ids is not None:
        return position_ids
    return torch.arange(seq_len, device=device)[None].expand(batch, seq_len)


class LlamaOutput(NamedTuple):
    hidden_states: torch.Tensor
    kv_cache: Optional[KVCache]
    # per-layer activation statistics (ops/awq.py), with collect_stats only
    stats: Optional[dict] = None


LORA_TARGETS = ("W_query", "W_key", "W_value", "out_proj", "w_gate", "w_up", "w_down")


class Dropout(NamedTuple):
    """LoRA input dropout at ``rate``; ``seed`` starts its own generator, so
    a recomputed block (``remat``) draws the same mask. ``rows``: ``(start,
    total)`` of this data-parallel rank's batch rows, the mask drawn for all
    ``total`` and sliced (None: the input's own rows); ``tokens`` the same
    for a sequence-parallel rank's token chunk (dim 1)."""

    rate: float
    seed: int
    rows: Optional[tuple] = None
    tokens: Optional[tuple] = None


def dropout_mask(x: torch.Tensor, dropout: Dropout, feats: Optional[tuple] = None):
    """The keep mask of ``x [B, ..., F]``: drawn at the one-device shape,
    ``dropout.rows``, ``dropout.tokens`` and ``feats`` (``(start, total)``
    of a row-parallel input's features) giving this rank's slice of it."""
    shape = list(x.shape)
    if dropout.rows is not None:
        shape[0] = dropout.rows[1]
    if dropout.tokens is not None:
        shape[1] = dropout.tokens[1]
    if feats is not None:
        shape[-1] = feats[1]
    gen = torch.Generator(device=x.device).manual_seed(dropout.seed)
    keep = torch.rand(shape, generator=gen, device=x.device) < 1.0 - dropout.rate
    if dropout.rows is not None:
        keep = keep.narrow(0, dropout.rows[0], x.shape[0])
    if dropout.tokens is not None:
        keep = keep.narrow(1, dropout.tokens[0], x.shape[1])
    if feats is not None:
        keep = keep.narrow(-1, feats[0], x.shape[-1])
    return keep


def dropout_seeds(gen: Optional[torch.Generator], n: int) -> list:
    """``n`` seeds for dropout streams from ``gen`` (``None``: none)."""
    if gen is None:
        return [None] * n
    return torch.randint(0, 2**62, (n,), generator=gen, device=gen.device).tolist()


def maybe_lora(x: torch.Tensor, base_out: torch.Tensor, adapter: Optional[dict],
               layer: Optional[int] = None, dropout: Optional[Dropout] = None,
               tp=None) -> torch.Tensor:
    """``base_out + scaling * (dropout(x) @ A) @ B`` (the JAX package's
    ``_maybe_lora``); ``layer`` picks one layer of a stacked adapter. The
    scaling multiplies the rank-r product, so autograd keeps only that
    ``[..., r]`` tensor for the scaling's gradient. A 3-D ``A`` (``[B, in,
    r]``, with ``B [B, r, out]`` and ``scaling [B]``: a bank gathered by
    row) gives each row of ``x [B, t, in]`` its own adapter, scaled after
    both products as in JAX. With ``tp`` (a ``TPShard``) a linear whose
    output is narrower than ``B`` takes the rank's columns of ``B``, one
    whose input is narrower than ``A`` the rank's rows of ``A`` (and of the
    dropout mask)."""
    if adapter is None:
        return base_out
    a, b, scaling = adapter["lora_a"], adapter["lora_b"], adapter["scaling"]
    if layer is not None:
        a, b, scaling = a[layer], b[layer], scaling[layer]
    feats = None
    if tp is not None:
        n_in, n_out = x.shape[-1], base_out.shape[-1]
        if n_in != a.shape[-2]:  # row-parallel: this rank's input features
            feats = (tp.slice_start(a.shape[-2], n_in), a.shape[-2])
            a = a.narrow(-2, feats[0], n_in)
        if n_out != b.shape[-1]:  # column-parallel: this rank's output columns
            b = b.narrow(-1, tp.slice_start(b.shape[-1], n_out), n_out)
    xin = x
    if dropout is not None and dropout.rate > 0.0:
        keep = dropout_mask(x, dropout, feats)
        xin = torch.where(keep, x / (1.0 - dropout.rate), torch.zeros((), dtype=x.dtype)).to(x.dtype)
    if a.dim() == 3:
        delta = torch.bmm(torch.bmm(xin, a.to(x.dtype)), b.to(x.dtype))
        return base_out + (scaling[:, None, None] * delta).to(base_out.dtype)
    delta = torch.matmul(torch.matmul(xin, a.to(x.dtype)) * scaling, b.to(x.dtype))
    return base_out + delta.to(base_out.dtype)


def _block_forward(h, block: DecoderBlock, layer_idx: int, config: LLAMA32Config, cos, sin,
                   structured: Optional[AttnMask], kv_cache: Optional[KVCache], impl: str,
                   lora: Optional[dict] = None, dropouts: Optional[dict] = None,
                   dense_mask: Optional[torch.Tensor] = None, collect_stats: bool = False,
                   tp=None):
    """One block: ``attn_out + ff_out``, and with ``collect_stats`` also the
    layer's statistics (a dict of fp32 vectors)."""
    b, t, _ = h.shape
    nq, nkv, hd = config.n_heads, config.n_kv_groups, config.head_dim
    if tp is not None:  # this rank's heads
        nq, nkv = tp.heads, tp.kv_heads
    att, ff = block.att, block.ff

    def proj(x, name, weight):
        out = linear(x, weight, impl)
        if lora is None or lora.get(name) is None:
            return out
        return maybe_lora(x, out, lora[name], layer_idx, (dropouts or {}).get(name), tp)

    normed = fused_add_rmsnorm(h, block.norm1.weight, config.rms_norm_eps, impl=impl)
    x_qkv = normed if tp is None else tp.copy_in(normed)  # f: column-parallel q, k, v
    q = proj(x_qkv, "W_query", att.W_query.weight).reshape(b, t, nq, hd).transpose(1, 2)
    k = proj(x_qkv, "W_key", att.W_key.weight).reshape(b, t, nkv, hd).transpose(1, 2)
    v = proj(x_qkv, "W_value", att.W_value.weight).reshape(b, t, nkv, hd).transpose(1, 2)
    q, k = apply_rotary_pos_emb(q, k, cos, sin)
    k_scale = v_scale = None
    if kv_cache is not None:  # post-RoPE keys cached; int8 caches return their scales
        k, v, k_scale, v_scale = kv_cache.update(layer_idx, k, v)

    attn = gqa_attention(q, k, v, structured, causal=True, impl=impl, mask=dense_mask,
                         k_scale=k_scale, v_scale=v_scale,
                         sp_mesh=None if tp is None else tp.mesh)
    attn = attn.transpose(1, 2).reshape(b, t, nq * hd)
    attn_out = proj(attn, "out_proj", att.out_proj.weight)
    if tp is not None:  # row-parallel: sum the ranks' partial products (g)
        attn_out = tp.reduce(attn_out)

    normed_ff = fused_add_rmsnorm(
        attn_out, block.norm2.weight, config.rms_norm_eps, residual=h, impl=impl
    )
    w_gate, w_up = ff.w_gate.weight, ff.w_up.weight
    x_ff = normed_ff if tp is None else tp.copy_in(normed_ff)  # f: column-parallel gate, up
    gateup_lora = lora is not None and (lora.get("w_gate") is not None
                                        or lora.get("w_up") is not None)
    if is_quantized(w_gate) or is_quantized(w_up) or gateup_lora:
        gate = proj(x_ff, "w_gate", w_gate)
        up = proj(x_ff, "w_up", w_up)
        inter = (F.silu(gate.float()) * up.float()).to(gate.dtype)
    else:
        inter = fused_swiglu(x_ff, w_gate, w_up, impl=impl)
    ff_out = proj(inter, "w_down", ff.w_down.weight)
    if tp is not None:
        ff_out = tp.reduce(ff_out)
    # residual-stream drop: the block input h is not added back
    out = attn_out + ff_out
    if not collect_stats:
        return out
    stats = {"norm1_absmean": normed.float().abs().mean(dim=(0, 1)),
             "norm2_absmean": normed_ff.float().abs().mean(dim=(0, 1)),
             "inter_absmean": inter.float().abs().mean(dim=(0, 1))}
    if tp is not None:
        stats = _mesh_stats(stats, tp.mesh)
    return out, stats


def _mesh_stats(stats: dict, mesh) -> dict:
    """A sharded rank's statistics made the one-device ones: the SwiGLU
    output's means gathered over ``tp``, every mean averaged over ``dp`` and
    ``sp`` (each rank's mean covers as many rows and tokens)."""
    stats = dict(stats, inter_absmean=mesh.all_gather(stats["inter_absmean"], AXIS_TP, dim=0))
    for axis in (AXIS_DP, AXIS_SP):
        n = mesh.shape[axis]
        if n > 1:
            stats = {k: mesh.all_reduce(v, axis) / n for k, v in stats.items()}
    return stats


def embed_tokens(model: LlamaModel, config: LLAMA32Config, ids: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``ids`` (clamped to the vocabulary; the
    ``<image>`` id may equal its size). A vocab-parallel rank looks up the
    ids in its range, zeroes the other rows and all-reduces."""
    ids = ids.clamp(0, config.vocab_size - 1)
    tp = model.tp
    if tp is None:
        return model.tok_emb[ids]
    local = ids - tp.vocab_start
    outside = (local < 0) | (local >= tp.vocab_rows)
    h = model.tok_emb[local.clamp(0, tp.vocab_rows - 1)].masked_fill(outside[..., None], 0)
    return tp.reduce(h)  # forward sum, gradient through (the vocab-parallel embedding)


def _structured_mask(attention_mask, b: int, t: int, kv_cache: Optional[KVCache],
                     device, q_offset: int = 0) -> AttnMask:
    """The structured mask of ``t`` new tokens; ``q_offset``: the global
    position of a sequence-parallel rank's first token (its chunk's keys
    are the 2D mask's own)."""
    if isinstance(attention_mask, AttnMask):
        return attention_mask
    if attention_mask is not None and attention_mask.dim() != 2:
        raise ValueError("attention_mask must be a 2D [B, S] padding mask, a dense additive "
                         f"[B, 1, Tq, Tk] mask or an AttnMask, got shape "
                         f"{tuple(attention_mask.shape)}")
    base = (torch.ones(b, t, dtype=torch.int32, device=device) if attention_mask is None
            else attention_mask.to(torch.int32))
    if kv_cache is None:
        return AttnMask(kv_valid=base, q_offset=q_offset)
    # the 2D mask covers the current tokens; cached slots are valid
    pos = kv_cache.pos
    if kv_cache.per_row:  # row b's tokens land at pos[b] .. pos[b]+t-1
        karange = torch.arange(kv_cache.max_length, device=device)[None, :]
        off = karange - pos[:, None]
        base_at = torch.gather(base, 1, off.clamp(0, t - 1))
        kv_valid = (karange < pos[:, None]) | ((off >= 0) & (off < t) & (base_at != 0))
        return AttnMask(kv_valid=kv_valid.to(torch.int32), q_offset=pos.to(torch.int32))
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
    lora: Optional[dict] = None,
    dropout_rng: Optional[torch.Generator] = None,
    lora_dropout: float = 0.0,
    remat: bool = False,
    gemv_routes=None,
    collect_stats: bool = False,
) -> LlamaOutput:
    """Decoder forward. With a ``kv_cache`` the new keys and values are written
    at ``kv_cache.pos`` in place and ``pos`` advances by the sequence length;
    the returned cache is the same object. A per-row cache (``pos`` an int64
    ``[B]`` tensor) writes row ``b`` at ``pos[b]``, takes its default RoPE
    positions from there, and leaves ``pos`` to its owner (the server).
    ``lora`` is the adapter tree (its
    ``"blocks"``); ``dropout_rng`` seeds one dropout stream per layer and
    target when ``lora_dropout > 0``. A 4D ``attention_mask`` (dense,
    additive, ``[B, 1, Tq, Tk]``) runs every layer's attention densely.
    Under sequence parallelism (the module's notes) the inputs and the
    returned hidden states are this rank's token chunk."""
    if gemv_routes is not None:
        not_in_slice("gemv_routes")
    if model.stage is not None:
        raise ValueError("a pipeline stage's model holds only its layers: run it through "
                         "parallel.pipeline (pipeline_causal_lm_loss)")
    tp = model.tp
    if input_embeds is not None:
        h = input_embeds
    elif input_ids is not None:
        h = embed_tokens(model, config, input_ids)
    else:
        raise ValueError("Either input_ids or input_embeds must be provided")

    b, t, _ = h.shape
    tokens = None if tp is None else tp.seq_tokens(t)
    if tokens is not None and kv_cache is not None:
        raise ValueError("a KV cache under sequence parallelism: the cache holds whole "
                         "sequences, and sp shards training batches")
    seq0 = 0 if tokens is None else tokens[0]
    # a 0-dim host tensor: no host-to-device copy (and stream sync) per forward
    h = h * torch.tensor(math.sqrt(config.hidden_size), dtype=h.dtype)
    dense_mask = structured = None
    if isinstance(attention_mask, torch.Tensor) and attention_mask.dim() == 4:
        dense_mask = attention_mask.to(h.dtype)  # prebuilt dense: pass through
    else:
        structured = _structured_mask(attention_mask, b, t, kv_cache, h.device, seq0)

    if position_ids is None:
        pos0 = kv_cache.pos if kv_cache is not None else seq0
        if isinstance(pos0, torch.Tensor):
            position_ids = pos0[:, None] + torch.arange(t, device=h.device)
        else:
            position_ids = (pos0 + torch.arange(t, device=h.device))[None].expand(b, t)
    scaling = config.rope_freq_dict if config.apply_rope_scaling else None
    cos, sin = rope_cos_sin(position_ids, config.head_dim, config.rope_base, h.dtype, scaling)

    blocks_lora = None if lora is None else lora.get("blocks")
    n_drop = len(LORA_TARGETS)
    use_dropout = blocks_lora is not None and lora_dropout > 0.0
    seeds = dropout_seeds(dropout_rng if use_dropout else None, config.n_layers * n_drop)
    rows = None if tp is None else tp.dp_rows(b)
    layer_stats = []
    for i, block in enumerate(model.blocks):
        dropouts = None
        if use_dropout and seeds[0] is not None:
            dropouts = {name: Dropout(lora_dropout, seeds[i * n_drop + j], rows, tokens)
                        for j, name in enumerate(LORA_TARGETS)}
        args = (h, block, i, config, cos, sin, structured, kv_cache, impl, blocks_lora, dropouts,
                dense_mask, collect_stats, tp)
        if remat and torch.is_grad_enabled():
            h = checkpoint(_block_forward, *args, use_reentrant=False)
        else:
            h = _block_forward(*args)
        if collect_stats:
            h, st = h
            layer_stats.append(st)
    if kv_cache is not None and not kv_cache.per_row:
        kv_cache.advance(t)

    h = fused_add_rmsnorm(h, model.final_norm.weight, config.rms_norm_eps, impl=impl)
    stats = None
    if collect_stats:
        stats = {key: torch.stack([st[key] for st in layer_stats]) for key in layer_stats[0]}
    return LlamaOutput(hidden_states=h, kv_cache=kv_cache, stats=stats)


def lm_head_apply(lm: CausalLM, config: LLAMA32Config, hidden: torch.Tensor,
                  impl: str = "auto", lora: Optional[dict] = None,
                  dropout: Optional[Dropout] = None) -> torch.Tensor:
    """Logits; a tied head reads the ``[vocab, hidden]`` embedding as it is
    (the JAX package's ``tok_emb.T``), a quantized head goes through
    ``qlinear``. ``lora`` is the head's flat adapter, or a bank's head
    gathered by row (``[B, in, r]``: one adapter per row of ``hidden``).
    A vocab-parallel head takes ``hidden`` through ``f`` and all-gathers its
    ranks' logits (its adapter's ``lora_b`` sliced to the rank's
    vocabulary)."""
    w = lm.model.tok_emb if lm.lm_head is None else lm.lm_head.weight
    tp = lm.model.tp
    if tp is None:
        return maybe_lora(hidden, linear(hidden, w, impl), lora, dropout=dropout)
    hidden = tp.copy_in(hidden)
    return tp.gather(maybe_lora(hidden, linear(hidden, w, impl), lora, dropout=dropout, tp=tp))


def causal_lm_forward(lm: CausalLM, config: LLAMA32Config, input_ids=None, input_embeds=None,
                      attention_mask=None, position_ids=None, kv_cache=None,
                      impl: str = "auto"):
    """``(logits, kv_cache)``."""
    out = llama_forward(lm.model, config, input_ids=input_ids, input_embeds=input_embeds,
                        attention_mask=attention_mask, position_ids=position_ids,
                        kv_cache=kv_cache, impl=impl)
    return lm_head_apply(lm, config, out.hidden_states, impl=impl), out.kv_cache
