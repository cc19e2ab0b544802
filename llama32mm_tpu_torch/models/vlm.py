"""The VLM: vision tower → projector → image-token splice → decoder → head
(counterpart of ``llama32mm_tpu/models/vlm.py``).

LoRA: ``lora["blocks"]`` adapts the decoder linears, ``lora["lm_head"]``
the head and ``lora["projector"]`` the projector. The vision tower runs
under ``torch.no_grad()`` when none of its parameters requires a gradient,
so a frozen tower keeps no activations (the JAX package closes over frozen
parameters).

Training extras: ``dropout_rng`` with ``vision_config.attention_dropout > 0``
turns on the ViT's attention dropout (``models/vision.py``);
``loss_chunk=N`` computes the loss by ``chunked_shifted_cross_entropy``, so
the ``[B, T, V]`` logits never exist; ``collect_stats=True`` returns the
decoder's per-layer activation statistics (``ops/awq.py``).

Data parallelism (a sharded model on a mesh with ``dp > 1``, each rank
given its rows of the batch): the loss is the global token mean, every
rank's NLL sum over the valid-target count summed over ``dp``, then summed
over ``dp`` forward with the gradient passed through (``g`` over ``dp``),
so every rank reports the one-device loss and its gradient is its own
share of the one-device gradient (the trainers sum them). A rank whose rows
are all padding adds 0 and no NaN.

Sequence parallelism (``sp > 1``, each rank given its rows' contiguous
token chunk; ``pixel_values`` whole for its rows): every sequence-parallel
rank runs the ViT and the projector on the same pixels; the splice finds
each row's first ``<image>`` in the row's ids gathered over ``sp`` and takes
the feature rows that fall in the rank's chunk; the labels are shifted over
the whole row (``shifted_targets``: the label after a chunk's last position
comes from the next rank), and the loss is the token mean over ``dp`` and
``sp``.

``encode_image`` runs under the profiler phases ``"vision_encode"`` and
``"mm_projector"``, the splice under ``"image_splice"``
(``utils/profiling.py::annotate``), the JAX package's names. The module's
``forward`` is ``vlm_forward`` returning the reference's dict."""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from llama32mm_tpu_torch.configs import MLLAMAConfig
from llama32mm_tpu_torch.models.common import Linear
from llama32mm_tpu_torch.models.language import (
    CausalLM,
    Dropout,
    dropout_seeds,
    embed_tokens,
    llama_forward,
    lm_head_apply,
    maybe_lora,
)
from llama32mm_tpu_torch.models.vision import VisionEncoder
from llama32mm_tpu_torch.parallel.mesh import AXIS_DP, AXIS_SP, reduce_from_tp
from llama32mm_tpu_torch.utils.kvcache import KVCache
from llama32mm_tpu_torch.utils.profiling import annotate


class VLMOutput(NamedTuple):
    logits: Optional[torch.Tensor]
    loss: Optional[torch.Tensor]
    hidden_states: torch.Tensor
    kv_cache: Optional[KVCache]
    # per-layer activation calibration stats (ops/awq.py), with collect_stats only
    stats: Optional[dict] = None


class MllamaForConditionalGeneration(nn.Module):
    def __init__(self, config: MLLAMAConfig, device, dtype: Optional[torch.dtype] = None,
                 tie_weights: bool = True):
        super().__init__()
        self.config = config
        dtype = dtype or config.text_config.torch_dtype
        self.vision_model = VisionEncoder(config.vision_config, device, dtype)
        self.multi_modal_projector = Linear(
            config.vision_config.hidden_size, config.text_config.hidden_size, True, device, dtype)
        self.language_model = CausalLM(config.text_config, device, dtype, tie_weights)

    def forward(self, input_ids=None, pixel_values=None, attention_mask=None, position_ids=None,
                labels=None, kv_cache=None, lora=None, impl: str = "auto", **kwargs) -> dict:
        """``vlm_forward`` (other keywords pass through to it), returned as
        the reference's dict ``{"logits", "loss", "hidden_states",
        "kv_cache"}``."""
        out = vlm_forward(self, self.config, input_ids=input_ids, pixel_values=pixel_values,
                          attention_mask=attention_mask, position_ids=position_ids,
                          labels=labels, kv_cache=kv_cache, lora=lora, impl=impl, **kwargs)
        return {"logits": out.logits, "loss": out.loss, "hidden_states": out.hidden_states,
                "kv_cache": out.kv_cache}


def init_vlm(config: MLLAMAConfig, device, gen: torch.Generator,
             tie_weights: bool = True) -> MllamaForConditionalGeneration:
    """Random-init model with the JAX package's ``init_vlm_params``
    distributions, drawn from ``gen`` (a generator on ``device``)."""
    model = MllamaForConditionalGeneration(config, device, tie_weights=tie_weights)
    with torch.no_grad():
        model.vision_model.init_(gen)
        bound = 1.0 / math.sqrt(config.vision_config.hidden_size)
        model.multi_modal_projector.weight.uniform_(-bound, bound, generator=gen)
        model.multi_modal_projector.bias.uniform_(-bound, bound, generator=gen)
        model.language_model.init_(gen)
    return model


def merge_input_ids_with_image_features(
    image_features: torch.Tensor,  # [B, N, H]
    inputs_embeds: torch.Tensor,  # [B, S, H]
    input_ids: torch.Tensor,  # [B, S]
    attention_mask,  # [B, S] tensor, an AttnMask, or None
    image_token_index: int,
    row_ids: Optional[torch.Tensor] = None,
    offset: int = 0,
):
    """Overwrite each row's first run of ``<image>`` positions,
    ``[first, first + N)`` clipped to the row, with the patch features, and
    mark those positions attended in a 2D mask (other masks pass through).
    A sequence-parallel rank passes its chunk (``input_ids``), the whole
    rows' ids (``row_ids [B, T]``, where the first ``<image>`` is found) and
    the chunk's global start ``offset``."""
    b, s = input_ids.shape
    n, hdim = image_features.shape[1], image_features.shape[2]
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)

    is_img = (input_ids if row_ids is None else row_ids) == image_token_index
    has_img = is_img.any(dim=1)
    start = is_img.to(torch.int32).argmax(dim=1)  # first occurrence; 0 when none
    rel = offset + torch.arange(s, device=input_ids.device)[None, :] - start[:, None]
    in_span = (rel >= 0) & (rel < n) & has_img[:, None]
    idx = rel.clamp(0, n - 1)[:, :, None].expand(b, s, hdim)
    gathered = torch.gather(image_features, 1, idx).to(inputs_embeds.dtype)
    merged = torch.where(in_span[:, :, None], gathered, inputs_embeds)
    if isinstance(attention_mask, torch.Tensor) and attention_mask.dim() == 2:
        attention_mask = torch.where(in_span, torch.ones_like(attention_mask), attention_mask)
    return merged, attention_mask


def encode_image(model: MllamaForConditionalGeneration, config: MLLAMAConfig,
                 pixel_values: torch.Tensor, impl: str = "auto", lora: Optional[dict] = None,
                 dropout: Optional[Dropout] = None,
                 dropout_rng: Optional[torch.Generator] = None,
                 rows: Optional[tuple] = None) -> torch.Tensor:
    """Vision tower + projector: ``[B, C, H, W] → [B, N, text_hidden]``.
    ``lora`` is the projector's flat adapter; ``dropout_rng`` drives the
    tower's attention dropout (``rows``: this data-parallel rank's batch
    rows, as ``Dropout.rows``)."""
    frozen = not any(p.requires_grad for p in model.vision_model.parameters())
    with annotate("vision_encode"), torch.no_grad() if frozen else contextlib.nullcontext():
        feats = model.vision_model(pixel_values, impl=impl, dropout_rng=dropout_rng,
                                   attention_dropout=config.vision_config.attention_dropout,
                                   rows=rows)
    with annotate("mm_projector"):
        proj = model.multi_modal_projector
        out = torch.matmul(feats, proj.weight.t()) + proj.bias
    return maybe_lora(feats, out, lora, dropout=dropout)


def vlm_forward(
    model: MllamaForConditionalGeneration,
    config: MLLAMAConfig,
    input_ids: Optional[torch.Tensor] = None,
    pixel_values: Optional[torch.Tensor] = None,
    attention_mask=None,
    position_ids: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    kv_cache: Optional[KVCache] = None,
    impl: str = "auto",
    logits_positions: Optional[torch.Tensor] = None,
    lora: Optional[dict] = None,
    dropout_rng: Optional[torch.Generator] = None,
    lora_dropout: float = 0.0,
    remat: bool = False,
    loss_chunk: Optional[int] = None,
    gemv_routes=None,
    collect_stats: bool = False,
) -> VLMOutput:
    """The VLM forward. ``logits_positions [B, k]`` computes the head only at
    those positions (prefill needs only the last valid one). ``dropout_rng``
    (a ``torch.Generator``) drives the LoRA input dropout when
    ``lora_dropout > 0``: the projector's, each decoder layer's and the
    head's streams are seeded from it, and with ``attention_dropout > 0`` the
    ViT's layers after them. ``loss_chunk`` (needs ``labels``) returns the
    loss with ``logits=None``."""
    tc = config.text_config
    lm = model.language_model
    lora = lora or {}
    proj_seed, head_seed = dropout_seeds(dropout_rng if lora_dropout > 0.0 else None, 2)
    tp = lm.model.tp
    mesh = None if tp is None else tp.mesh
    rows = tokens = None
    if tp is not None:
        rows = tp.dp_rows((input_ids if input_ids is not None else pixel_values).shape[0])
        if input_ids is not None:
            tokens = tp.seq_tokens(input_ids.shape[1])
    if tokens is not None and logits_positions is not None:
        raise ValueError("logits_positions under sequence parallelism: prefill runs whole "
                         "sequences")

    def dropout(seed, seq=True):
        return None if seed is None else Dropout(lora_dropout, seed, rows,
                                                 tokens if seq else None)

    inputs_embeds = None
    if input_ids is not None:
        inputs_embeds = embed_tokens(lm.model, tc, input_ids)
    if pixel_values is not None and inputs_embeds is not None:
        # the image features are whole on every sequence-parallel rank
        feats = encode_image(model, config, pixel_values.to(inputs_embeds.dtype), impl=impl,
                             lora=lora.get("projector"), dropout=dropout(proj_seed, seq=False),
                             dropout_rng=dropout_rng, rows=rows)
        with annotate("image_splice"):
            row_ids, offset = None, 0
            if tokens is not None:
                row_ids, offset = mesh.all_gather(input_ids, AXIS_SP, dim=1), tokens[0]
            inputs_embeds, attention_mask = merge_input_ids_with_image_features(
                feats, inputs_embeds, input_ids, attention_mask, config.image_token_index,
                row_ids, offset)

    out = llama_forward(
        lm.model, tc, input_embeds=inputs_embeds, attention_mask=attention_mask,
        position_ids=position_ids, kv_cache=kv_cache, impl=impl, lora=lora,
        dropout_rng=dropout_rng, lora_dropout=lora_dropout, remat=remat,
        gemv_routes=gemv_routes, collect_stats=collect_stats,
    )
    hidden = out.hidden_states
    if logits_positions is not None:
        if labels is not None:
            raise ValueError("logits_positions is incompatible with labels")
        idx = logits_positions.long()[:, :, None].expand(-1, -1, hidden.shape[-1])
        hidden = torch.gather(hidden, 1, idx)
    if loss_chunk is not None:
        # head-LoRA applies; head-LoRA dropout does not on this path (as in JAX)
        if labels is None:
            raise ValueError("loss_chunk requires labels")
        loss = chunked_shifted_cross_entropy(lm, tc, hidden, labels, config.ignore_index,
                                             chunk=loss_chunk, lora=lora.get("lm_head"),
                                             impl=impl, mesh=mesh)
        return VLMOutput(logits=None, loss=loss, hidden_states=out.hidden_states,
                         kv_cache=out.kv_cache, stats=out.stats)
    logits = lm_head_apply(lm, tc, hidden, impl=impl, lora=lora.get("lm_head"),
                           dropout=dropout(head_seed))
    loss = None if labels is None else shifted_cross_entropy(logits, labels, config.ignore_index,
                                                             mesh)
    return VLMOutput(logits=logits, loss=loss, hidden_states=out.hidden_states,
                     kv_cache=out.kv_cache, stats=out.stats)


def _chunk_nll(lm: CausalLM, config, lora, impl: str, ignore_index: int, h_c: torch.Tensor,
               t_c: torch.Tensor):
    """``(sum of the chunk's NLL, its valid targets)`` in fp32."""
    logits = lm_head_apply(lm, config, h_c, impl=impl, lora=lora)
    return _nll_sum(logits, t_c, ignore_index)


def _nll_sum(logits: torch.Tensor, targets: torch.Tensor, ignore_index: int):
    valid = targets != ignore_index
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, targets, 0)[..., None].long())[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum(), valid.sum()


def _mean_over_mesh(nll_sum: torch.Tensor, count: torch.Tensor, mesh) -> torch.Tensor:
    """``nll_sum / count``; under ``dp`` and ``sp`` the count is summed over
    the ranks first and the rank's quotient summed over them forward only
    (the global token mean on every rank, each rank's gradient its own
    share)."""
    axes = [] if mesh is None else [a for a in (AXIS_DP, AXIS_SP) if mesh.shape[a] > 1]
    if not axes:
        return nll_sum / count.clamp(min=1)
    count = count.detach().clone()
    for axis in axes:
        count = mesh.all_reduce(count, axis)
    loss = nll_sum / count.clamp(min=1)
    for axis in axes:
        loss = reduce_from_tp(loss, mesh, axis)
    return loss


def shifted_targets(labels: torch.Tensor, ignore_index: int, mesh=None) -> torch.Tensor:
    """The next-token targets of ``labels``: ``labels[:, 1:]``, or under
    ``sp`` (a rank's token chunk) the chunk's labels from its second on,
    then the next rank's first label (``ignore_index`` on the last rank), so
    each of the chunk's positions has the target the whole row gives it."""
    if mesh is None or mesh.shape[AXIS_SP] == 1:
        return labels[:, 1:]
    nxt = mesh.ppermute(labels[:, :1].contiguous(), AXIS_SP, shift=-1)
    if mesh.rank(AXIS_SP) == mesh.shape[AXIS_SP] - 1:
        nxt = torch.full_like(nxt, ignore_index)
    return torch.cat([labels[:, 1:], nxt], dim=1)


def _shifted(hidden: torch.Tensor, labels: torch.Tensor, ignore_index: int, mesh):
    """The positions that predict a next token, and their targets."""
    targets = shifted_targets(labels, ignore_index, mesh)
    return hidden[:, :targets.shape[1]], targets


def chunked_shifted_cross_entropy(lm: CausalLM, config, hidden: torch.Tensor,
                                  labels: torch.Tensor, ignore_index: int, chunk: int = 1024,
                                  lora: Optional[dict] = None,
                                  impl: str = "auto", mesh=None) -> torch.Tensor:
    """``shifted_cross_entropy`` without the full ``[B, T, V]`` logits: the
    shifted positions stream through the head and an fp32 log-softmax
    ``chunk`` at a time, each chunk under ``torch.utils.checkpoint``, so the
    backward recomputes one chunk's logits from its saved hidden slice (the
    JAX package's rematerialized ``lax.scan``). ``lora`` is the head's
    adapter; ``mesh`` as in ``shifted_cross_entropy``."""
    sh, st = _shifted(hidden, labels, ignore_index, mesh)
    n = sh.shape[1]
    chunk = int(min(chunk, n))
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for start in range(0, n, chunk):
        args = (lm, config, lora, impl, ignore_index, sh[:, start:start + chunk],
                st[:, start:start + chunk])
        if torch.is_grad_enabled():
            part, valid = checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            part, valid = _chunk_nll(*args)
        nll_sum = nll_sum + part
        cnt = cnt + valid
    return _mean_over_mesh(nll_sum, cnt, mesh)


def shifted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int, mesh=None) -> torch.Tensor:
    """Next-token cross entropy, mean over labels that are not
    ``ignore_index``; with a ``mesh`` of ``dp > 1`` or ``sp > 1`` (each rank
    holding its rows, its token chunk), the mean over every rank's labels."""
    logits, targets = _shifted(logits, labels, ignore_index, mesh)
    nll_sum, count = _nll_sum(logits, targets, ignore_index)
    return _mean_over_mesh(nll_sum, count, mesh)
