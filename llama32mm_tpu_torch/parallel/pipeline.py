"""Pipeline parallelism over the ``pp`` mesh axis, the GPipe microbatch
schedule (counterpart of ``llama32mm_tpu/parallel/pipeline.py``).

- A **stage** holds a contiguous ``L / pp`` of the decoder's layers
  (``pipeline_shard_params``), and with ``tp=True`` their tensor-parallel
  shards; the embedding, the final norm and the head stay whole and
  replicated on every stage, as the JAX package places them.
- The **schedule** (``pipeline_decoder_hidden``) runs ``M + pp - 1`` steps
  on every rank. Stage 0 feeds microbatch ``i`` (the last one again once
  they run out), the others what the previous stage sent; each stage runs
  its layers and the output hops on by ``ppermute`` over ``pp``; the last
  stage writes its finished microbatch to slot ``i - (pp - 1)``. The
  slots are broadcast to every stage by a masked sum over ``pp``, then the
  final norm. Bubble steps compute like the others (their results are
  never written), so every rank builds the same graph and issues the same
  collectives in the same order (the last step sends nothing). The bubble
  share is ``(pp - 1) / (M + pp - 1)``.
- The **backward** is autograd's reverse of that graph: ``ppermute``'s
  backward is the reverse rotation. Each rank's loss reaches its stage's
  outputs through two ties that carry no value forward, so that the
  backward visits them on every rank: stage 0 picks its input from the
  microbatch and the received buffer with ``torch.where`` (the buffer's
  gradient is 0 there), and every stage masks its writes with
  ``torch.where`` (0 except on the last stage). The permutes' backwards run
  in the one order their chain allows, the same on every rank.
- **Replicated leaves**: each rank computes the embedding, the final norm,
  the head and the loss itself, on the same broadcast hidden states, so
  the final norm's and the head's gradients are whole and equal on every
  stage. Only stage 0's schedule reads the embedding: its lookup passes
  ``copy_to_tp`` over ``pp`` (identity forward, the gradient summed over
  ``pp`` backward), which gives every stage stage 0's share.
- ``remat=True`` recomputes each layer in the backward
  (``torch.utils.checkpoint``), within its stage. Dropout is not supported,
  as in the JAX package. The trainers (``make_pipeline_lora_train_step``,
  ``make_pipeline_train_step``) take ``optax.adam``'s step (no decay, no
  clip) on every rank's own tensors after summing the gradients over
  ``dp`` (and the block adapters' over ``tp``).

``dp`` composes (each rank given its rows, ``n_microbatches`` of them a
rank) and ``tp`` composes (``tp=True``); ``sp`` does not (``shard_params``
refuses a mesh with both). Text only: the VLM's image path does not run
through the pipeline.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from llama32mm_tpu_torch.configs import LLAMA32Config
from llama32mm_tpu_torch.models.common import copy_module
from llama32mm_tpu_torch.models.language import _block_forward, lm_head_apply
from llama32mm_tpu_torch.models.vlm import chunked_shifted_cross_entropy, shifted_cross_entropy
from llama32mm_tpu_torch.ops.attention import AttnMask
from llama32mm_tpu_torch.ops.rmsnorm import fused_add_rmsnorm
from llama32mm_tpu_torch.ops.rope import rope_cos_sin
from llama32mm_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_PP,
    AXIS_TP,
    Mesh,
    copy_to_tp,
    ppermute,
    reduce_from_tp,
)
from llama32mm_tpu_torch.parallel.sharding import (
    Placement,
    TPShard,
    _localize,
    param_shardings,
    placement_of,
)


class PipelineStage:
    """A stage's state on one rank: the mesh, the global index of its first
    layer, and the ``TPShard`` of its layers (``tp=True``; None otherwise)."""

    def __init__(self, mesh: Mesh, first_layer: int, tp: Optional[TPShard] = None):
        self.mesh = mesh
        self.first_layer = first_layer
        self.tp = tp

    @property
    def index(self) -> int:
        return self.mesh.rank(AXIS_PP)


def _check_layers(config: LLAMA32Config, pp: int) -> None:
    if config.n_layers % pp:
        raise ValueError(f"n_layers {config.n_layers} not divisible by pp={pp}")


def pipeline_param_specs(model: nn.Module, mesh: Mesh, tp: bool = False) -> dict:
    """``{state_dict name: (stage, Placement)}`` of a ``CausalLM``: the
    decoder layers' tensors on the stage that holds their layer (``L / pp``
    contiguous layers a stage) and, with ``tp=True``, split over ``tp`` as
    ``param_shardings`` splits them; every other tensor on every stage
    (``None``) and whole."""
    config = model.config
    _check_layers(config, mesh.shape[AXIS_PP])
    per = config.n_layers // mesh.shape[AXIS_PP]
    plan = param_shardings(config, mesh, model) if tp else {}
    out = {}
    for name, _ in list(model.named_parameters()) + list(model.named_buffers()):
        parts = name.split(".")
        if "blocks" in parts:
            layer = int(parts[parts.index("blocks") + 1])
            out[name] = (layer // per, plan.get(name, Placement(mesh)))
        else:
            out[name] = (None, Placement(mesh))
    return out


def pipeline_shard_params(model: nn.Module, mesh: Mesh, tp: bool = False) -> nn.Module:
    """This rank's stage of ``model`` (a ``CausalLM``, float or quantized):
    a copy whose decoder holds only the stage's layers (their TP shards with
    ``tp=True``, fresh tensors; otherwise shared with ``model``) and a
    ``PipelineStage``; the embedding, the final norm and the head shared with
    ``model``."""
    if not mesh.member:
        raise ValueError("this rank is not in the mesh")
    config = model.config
    specs = pipeline_param_specs(model, mesh, tp)
    stage, per = mesh.rank(AXIS_PP), config.n_layers // mesh.shape[AXIS_PP]
    first = stage * per
    new = copy_module(model)
    new.model = copy_module(model.model)
    blocks = list(model.model.blocks)[first:first + per]
    shard = None
    if tp:
        plan = {name: pl for name, (_, pl) in specs.items()}
        blocks = [_localize(b, f"model.blocks.{first + i}.", plan) for i, b in enumerate(blocks)]
        n = mesh.shape[AXIS_TP]
        shard = TPShard(mesh, config.n_heads // n, max(1, config.n_kv_groups // n))
    new.model.blocks = nn.ModuleList(blocks)
    new.model.stage = PipelineStage(mesh, first, shard)
    return new


def pipeline_shard_lora(lora: dict, mesh: Mesh) -> dict:
    """The adapters for the pipeline: the block adapters' stage slice (its
    ``L / pp`` layers of each ``[L, ...]`` leaf, fresh tensors), the head's
    and the projector's shared (replicated)."""
    pp, stage = mesh.shape[AXIS_PP], mesh.rank(AXIS_PP)
    out = {k: v for k, v in lora.items() if k != "blocks"}
    if "blocks" in lora:
        out["blocks"] = {}
        for name, ad in lora["blocks"].items():
            per = ad["lora_a"].shape[0] // pp
            out["blocks"][name] = {leaf: t[stage * per:(stage + 1) * per].detach().clone()
                                   for leaf, t in ad.items()}
    return out


def pipeline_decoder_hidden(model: nn.Module, config: LLAMA32Config, h: torch.Tensor, mesh: Mesh,
                            n_microbatches: int, *, lora_blocks: Optional[dict] = None,
                            remat: bool = False, impl: str = "auto") -> torch.Tensor:
    """The decoder stack run pipelined over ``pp`` (the module's notes);
    returns the final-normed hidden states ``[b, T, H]`` on every stage.
    ``model``: the stage's ``LlamaModel`` (``pipeline_shard_params``); ``h``:
    the embedded, scaled hidden states of this rank's rows; ``lora_blocks``:
    the stage's slice of the block adapters (``pipeline_shard_lora``)."""
    stage = model.stage
    if stage is None:
        raise ValueError("the model is not a pipeline stage: place it with pipeline_shard_params")
    pp, m = mesh.shape[AXIS_PP], n_microbatches
    _check_layers(config, pp)
    b, t, hidden = h.shape
    if b % m:
        dp = mesh.shape[AXIS_DP]
        raise ValueError(f"batch {b * dp} must divide dp*microbatches = {dp}*{m}")
    mb = b // m
    pos = torch.arange(t, device=h.device)[None]
    scaling = config.rope_freq_dict if config.apply_rope_scaling else None
    cos, sin = rope_cos_sin(pos, config.head_dim, config.rope_base, h.dtype, scaling)
    causal = AttnMask(kv_valid=torch.ones(mb, t, dtype=torch.int32, device=h.device), q_offset=0)
    first = torch.tensor(stage.index == 0, device=h.device)
    last = torch.tensor(stage.index == pp - 1, device=h.device)

    def run_stage(x):
        for i, block in enumerate(model.blocks):
            args = (x, block, i, config, cos, sin, causal, None, impl, lora_blocks, None, None,
                    False, stage.tp)
            if remat and torch.is_grad_enabled():
                x = checkpoint(_block_forward, *args, use_reentrant=False)
            else:
                x = _block_forward(*args)
        return x

    micro = h.reshape(m, mb, t, hidden)
    buf = torch.zeros(mb, t, hidden, dtype=h.dtype, device=h.device)
    slots = [None] * m
    for i in range(m + pp - 1):
        y = run_stage(torch.where(first, micro[min(i, m - 1)], buf))
        if i >= pp - 1:  # the last stage's finished microbatch; zeros elsewhere
            slots[i - (pp - 1)] = torch.where(last, y, torch.zeros((), dtype=y.dtype,
                                                                     device=y.device))
        if i < m + pp - 2:  # the last step's output goes nowhere
            buf = ppermute(y, mesh, AXIS_PP)
    out = reduce_from_tp(torch.cat(slots, dim=0), mesh, AXIS_PP)  # broadcast from the last stage
    return fused_add_rmsnorm(out, model.final_norm.weight, config.rms_norm_eps, impl=impl)


def pipeline_causal_lm_loss(model: nn.Module, config: LLAMA32Config, input_ids: torch.Tensor,
                            labels: torch.Tensor, mesh: Mesh, n_microbatches: int, *,
                            ignore_index: int = -100, lora: Optional[dict] = None,
                            remat: bool = False, loss_chunk: Optional[int] = None,
                            impl: str = "auto") -> torch.Tensor:
    """Shifted next-token cross entropy through the pipelined decoder (text
    only): the global token mean over ``dp`` on every rank. ``model``: the
    stage's ``CausalLM``; ``lora``: the adapter tree with the stage's block
    slices (``pipeline_shard_lora``), whose head adapter applies outside the
    stages; ``loss_chunk`` streams the head and the log-softmax in chunks
    (``models/vlm.py::chunked_shifted_cross_entropy``)."""
    ids = input_ids.clamp(0, config.vocab_size - 1)
    h = model.model.tok_emb[ids]
    h = h * torch.tensor(math.sqrt(config.hidden_size), dtype=h.dtype)
    h = copy_to_tp(h, mesh, AXIS_PP)  # only stage 0 reads it: its gradient summed over pp
    lora = lora or {}
    h = pipeline_decoder_hidden(model.model, config, h, mesh, n_microbatches,
                                lora_blocks=lora.get("blocks"), remat=remat, impl=impl)
    if loss_chunk:
        return chunked_shifted_cross_entropy(model, config, h, labels, ignore_index,
                                             chunk=loss_chunk, lora=lora.get("lm_head"),
                                             impl=impl, mesh=mesh)
    logits = lm_head_apply(model, config, h, impl=impl, lora=lora.get("lm_head"))
    return shifted_cross_entropy(logits.float(), labels, ignore_index, mesh)


def make_pipeline_lora_train_step(config: LLAMA32Config, mesh: Mesh, n_microbatches: int,
                                  learning_rate=1e-4, *, remat: bool = False,
                                  loss_chunk: Optional[int] = None, impl: str = "auto"):
    """``(init_state, step)``: LoRA (QLoRA over a quantized base) through the
    pipeline. ``init_state(lora)`` takes the adapters of
    ``pipeline_shard_lora``; ``step(model, state, batch, rng=None) ->
    (state, loss)`` (``model`` the stage's, ``batch`` this rank's rows of
    ``input_ids`` and ``labels``; ``rng`` unused: no dropout) sums the block
    adapters' gradients over ``tp`` (each tensor-parallel rank reads its
    slice) and every gradient over ``dp``, then takes ``optax.adam``'s
    step. The head's adapter is whole on every stage."""
    from llama32mm_tpu_torch.train.accum import all_reduce_flat, loss_and_grads
    from llama32mm_tpu_torch.train.lora import LoraTrainState, lora_leaves
    from llama32mm_tpu_torch.train.optim import Adam

    tx = Adam(learning_rate)

    def init_state(lora: dict) -> LoraTrainState:
        flat = lora_leaves(lora)
        for t in flat.values():
            t.requires_grad_(True)
        return LoraTrainState(lora=lora, opt_state=tx.init(flat), step=0)

    def step(model, state: LoraTrainState, batch: dict, rng=None):
        del rng
        flat = lora_leaves(state.lora)
        with torch.enable_grad():
            loss = pipeline_causal_lm_loss(model, config, batch["input_ids"], batch["labels"],
                                           mesh, n_microbatches, lora=state.lora, remat=remat,
                                           loss_chunk=loss_chunk, impl=impl)
            loss, grads = loss_and_grads(loss, list(flat.values()))
        if model.model.stage.tp is not None:
            all_reduce_flat([g for name, g in zip(flat, grads) if name.startswith("blocks.")],
                            mesh, AXIS_TP)
        all_reduce_flat(grads, mesh, AXIS_DP)
        opt_state = tx.step(flat, dict(zip(flat, grads)), state.opt_state)
        return LoraTrainState(lora=state.lora, opt_state=opt_state, step=state.step + 1), loss

    return init_state, step


class PipelineTrainState(NamedTuple):
    model: nn.Module  # the stage's model, its parameters updated in place
    opt_state: object  # AdamState keyed by the stage model's parameter names
    step: int


def make_pipeline_train_step(config: LLAMA32Config, mesh: Mesh, n_microbatches: int,
                             learning_rate=1e-4, *, remat: bool = False,
                             loss_chunk: Optional[int] = None, impl: str = "auto"):
    """``(init_state, step)`` training every parameter of a stage's causal LM
    through the pipeline, the ``pp x dp`` counterpart of ``train/full.py``:
    ``init_state(model)`` (the stage's, from ``pipeline_shard_params``)
    marks its parameters trainable; ``step(state, batch, rng=None) ->
    (state, loss)`` sums the gradients over ``dp`` (a kv head that several
    ``tp`` ranks hold over those ranks) and takes ``optax.adam``'s step on
    the stage's tensors: its layers' moments live on the stage."""
    from llama32mm_tpu_torch.train.accum import all_reduce_flat, loss_and_grads
    from llama32mm_tpu_torch.train.full import _kv_partial, _sum_kv_partial
    from llama32mm_tpu_torch.train.optim import Adam

    tx = Adam(learning_rate)

    def init_state(model) -> PipelineTrainState:
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        return PipelineTrainState(model=model, opt_state=tx.init(params), step=0)

    def step(state: PipelineTrainState, batch: dict, rng=None):
        del rng
        params = dict(state.model.named_parameters())
        with torch.enable_grad():
            loss = pipeline_causal_lm_loss(state.model, config, batch["input_ids"],
                                           batch["labels"], mesh, n_microbatches, remat=remat,
                                           loss_chunk=loss_chunk, impl=impl)
            loss, grads = loss_and_grads(loss, list(params.values()))
        grads = dict(zip(params, grads))
        for name, p in params.items():
            if _kv_partial(placement_of(p)):
                grads[name] = _sum_kv_partial(grads[name], placement_of(p))
        all_reduce_flat(list(grads.values()), mesh, AXIS_DP)
        opt_state = tx.step(params, grads, state.opt_state)
        return state._replace(opt_state=opt_state, step=state.step + 1), loss

    return init_state, step
