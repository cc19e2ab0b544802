"""Tensor-parallel layout of the model (counterpart of
``llama32mm_tpu/parallel/sharding.py``), Megatron style.

Each rank holds plain local tensors in the same ``nn.Module`` tree, so the
hand kernels see ordinary contiguous tensors at the sharded shapes; the
forward calls its collectives itself (``models/language.py``,
``models/vision.py``). The layout over ``tp`` (the JAX package's rules,
``[out, in]`` here where JAX stores ``[in, out]``):

- column-parallel: ``W_query``, ``w_gate``, ``w_up`` (split by query heads
  and by intermediate columns: dim 0), and ``W_key`` / ``W_value`` by kv
  head (below);
- row-parallel: ``out_proj``, ``w_down`` (dim 1); their partial products
  are all-reduced;
- vocab-parallel: ``tok_emb`` and the head (dim 0), tied or untied; the
  lookup zeroes the rows outside a rank's range and all-reduces, the head's
  logits are all-gathered;
- replicated: the norms, the projector and, by default, the ViT. With
  ``vision_tp`` the ViT's ``q/k/v_proj`` and ``fc1`` (weights and biases)
  are column-parallel, its ``out_proj`` and ``fc2`` weights row-parallel,
  their biases replicated and added once, after the all-reduce.

Kv heads are split per head, not per raw column, and this departs from the
JAX layout: with ``tp`` above ``n_kv_groups`` the JAX spec splits
``W_key``'s out axis ``tp`` ways, which cuts a head's ``head_dim`` apart
(GSPMD then gathers it back). Here each rank keeps whole the kv head its
query heads read, replicated across the ``tp / n_kv_groups`` ranks that
read it, so a rank's attention is ordinary GQA over whole heads. The KV
cache follows: each rank holds ``[L, B, n_kv_local, S, hd]``.

Quantized leaves (``QuantLinear`` buffers): ``q`` / ``q4`` take the float
weight's split. The int8 per-channel ``scale [N]`` follows the out axis, so
it is split for column-parallel leaves and replicated for row-parallel ones;
the int4 group scales ``[N, K/g]`` follow the weight on either axis. A
row-parallel int4 split falls on group boundaries (``K/tp`` a multiple of
``g``), so each group's ``g/2`` packed bytes stay whole on one rank.

Sequence parallelism (``sp``): the parameters are replicated over ``sp``
(the TP placement only, as in the JAX package) and each ``(dp, sp)`` rank
takes its rows and its contiguous token chunk of the batch
(``seq_data_sharding``); the forward reads the mesh from the ``TPShard``
(``models/language.py``, ``ops/attention.py``). Pipeline stages are placed
by ``parallel/pipeline.py``; ``shard_params`` on a mesh with ``pp > 1``
replicates over ``pp``, as the JAX package's rules do.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from llama32mm_tpu_torch.configs import MLLAMAConfig
from llama32mm_tpu_torch.models.common import copy_module
from llama32mm_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    Mesh,
    copy_to_tp,
    gather_from_tp,
    reduce_from_tp,
)


class Placement:
    """Where one tensor's slices live on a mesh. Its first split is ``dim``
    cut into ``parts`` equal slices along the mesh axis ``axis`` (None:
    replicated), rank ``r`` of the axis's ``n`` ranks holding slice ``r *
    parts // n``; ``parts`` is the axis size except for kv heads fewer than
    ``tp``, which each several ranks hold. ``extend`` adds a split along
    another axis on another dim (ZeRO-1's ``dp`` split of the optimizer
    state, ``zero1_shardings``); ``splits`` lists them all as ``(dim,
    parts, axis)``."""

    __slots__ = ("mesh", "splits")

    def __init__(self, mesh: Mesh, dim: Optional[int] = None, parts: int = 1,
                 axis: str = AXIS_TP, splits: tuple = ()):
        self.mesh = mesh
        self.splits = tuple(splits) if splits else (
            () if dim is None else ((dim, parts, axis),))

    @property
    def dim(self) -> Optional[int]:
        return self.splits[0][0] if self.splits else None

    @property
    def parts(self) -> int:
        return self.splits[0][1] if self.splits else 1

    @property
    def axis(self) -> str:
        return self.splits[0][2] if self.splits else AXIS_TP

    def _index(self, parts: int, axis: str, coords: Optional[dict] = None) -> int:
        r = self.mesh.rank(axis) if coords is None else coords[axis]
        return r * parts // self.mesh.shape[axis]

    @property
    def index(self) -> int:
        return self._index(self.parts, self.axis)

    def extend(self, dim: int, parts: int, axis: str) -> "Placement":
        """This placement with ``dim`` also cut into ``parts`` along ``axis``."""
        return Placement(self.mesh, splits=self.splits + ((dim, parts, axis),))

    def drop(self, dim: int) -> "Placement":
        """The placement of a reduction of the tensor over ``dim`` (that
        dim's splits gone, the later dims one lower)."""
        return Placement(self.mesh, splits=tuple((d - (d > dim), parts, axis)
                                                 for d, parts, axis in self.splits if d != dim))

    def local_range(self, size: int) -> tuple:
        """``(start, length)`` of this rank's slice of the first split's dim."""
        if self.dim is None:
            return 0, size
        chunk = size // self.parts
        return self.index * chunk, chunk

    def box(self, shape, coords: Optional[dict] = None) -> list:
        """``[(start, length)]`` per dim of the slice that the rank at
        ``coords`` (default: this rank) holds of a tensor of the whole
        ``shape``."""
        box = [[0, n] for n in shape]
        for dim, parts, axis in self.splits:
            length = box[dim][1] // parts
            box[dim] = [box[dim][0] + self._index(parts, axis, coords) * length, length]
        return [tuple(b) for b in box]

    def local_shape(self, shape) -> tuple:
        shape = list(shape)
        for dim, parts, _ in self.splits:
            shape[dim] //= parts
        return tuple(shape)

    def full_shape(self, local_shape) -> tuple:
        shape = list(local_shape)
        for dim, parts, _ in self.splits:
            shape[dim] *= parts
        return tuple(shape)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor ``t`` (a view); raises
        ``ValueError`` where a split dim does not divide."""
        for dim, parts, axis in self.splits:
            if t.shape[dim] % parts:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {parts} "
                                 f"over {axis!r}")
        for dim, (start, length) in enumerate(self.box(t.shape)):
            if length != t.shape[dim]:
                t = t.narrow(dim, start, length)
        return t

    def split_over(self, axis: str) -> int:
        """How many slices this placement cuts along ``axis`` (1: none)."""
        return math.prod(parts for _, parts, a in self.splits if a == axis)

    def replicas(self, axis: str) -> int:
        """How many ranks along ``axis`` hold each of its slices."""
        return self.mesh.shape[axis] // self.split_over(axis)

    def __repr__(self) -> str:
        if not self.splits:
            return "Placement(replicated)"
        if len(self.splits) == 1:
            return f"Placement(dim={self.dim}, parts={self.parts}, axis={self.axis!r})"
        return f"Placement(splits={self.splits})"


# The attribute a local tensor of a sharded model or train state carries its
# Placement in (a torch tensor has no layout of its own, where a JAX array
# carries its sharding): set by shard_params, the optimizers and the
# checkpointer's restore, read by the trainers, the optimizers and the
# checkpointer. Copies (``detach``, ``state_dict()``) do not carry it.
_PLACEMENT = "_llama32mm_placement"


def set_placement(t: torch.Tensor, placement: Optional[Placement]) -> torch.Tensor:
    """Note ``t``'s placement (None: a one-device tensor); returns ``t``."""
    if placement is not None:
        setattr(t, _PLACEMENT, placement)
    elif hasattr(t, _PLACEMENT):
        delattr(t, _PLACEMENT)
    return t


def placement_of(t: torch.Tensor) -> Optional[Placement]:
    """The placement noted for ``t``, or None (a one-device tensor)."""
    return getattr(t, _PLACEMENT, None)


class TPShard:
    """A tower's tensor-parallel state on one rank: its local head counts,
    its vocabulary range (the decoder), and the collectives of its ``tp``
    group. A module without one runs on one device, with no collective."""

    def __init__(self, mesh: Mesh, heads: int, kv_heads: int, vocab_start: int = 0,
                 vocab_rows: int = 0):
        self.mesh = mesh
        self.heads = heads
        self.kv_heads = kv_heads
        self.vocab_start = vocab_start
        self.vocab_rows = vocab_rows

    @property
    def rank(self) -> int:
        return self.mesh.rank(AXIS_TP)

    @property
    def size(self) -> int:
        return self.mesh.shape[AXIS_TP]

    def slice_start(self, full: int, local: int) -> int:
        """Where this rank's ``local`` columns start in a ``full``-wide
        axis split into ``full // local`` slices over ``tp`` (kv heads
        fewer than ``tp`` repeat across ranks)."""
        return self.rank * (full // local) // self.size * local

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(x, AXIS_TP)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """``f`` on a column-parallel linear's input (``mesh.copy_to_tp``)."""
        return copy_to_tp(x, self.mesh)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``g`` on row-parallel partial products (``mesh.reduce_from_tp``)."""
        return reduce_from_tp(x, self.mesh)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Vocab-sharded ``[..., V/tp]`` logits → the full ``[..., V]``
        (``gather_from_tp``)."""
        return gather_from_tp(x, self.mesh)

    def dp_rows(self, local_rows: int) -> Optional[tuple]:
        """``(start, total)`` of this rank's batch rows under ``dp``, or None
        when the mesh has one data-parallel rank."""
        n = self.mesh.shape[AXIS_DP]
        return None if n == 1 else (self.mesh.rank(AXIS_DP) * local_rows, local_rows * n)

    @property
    def sp(self) -> int:
        """The number of sequence-parallel ranks (1: whole sequences)."""
        return self.mesh.shape[AXIS_SP]

    def seq_tokens(self, local_tokens: int) -> Optional[tuple]:
        """``(start, total)`` of this rank's token chunk under ``sp``, or
        None when the mesh has one sequence-parallel rank."""
        n = self.sp
        return None if n == 1 else (self.mesh.rank(AXIS_SP) * local_tokens, local_tokens * n)


_COLUMN = frozenset({"W_query", "w_gate", "w_up"})
_KV = frozenset({"W_key", "W_value"})
_ROW = frozenset({"out_proj", "w_down"})
_VIS_COLUMN = frozenset({"q_proj", "k_proj", "v_proj", "fc1"})
_VIS_ROW = frozenset({"out_proj", "fc2"})


def _text_config(config):
    return getattr(config, "text_config", config)


def _check_divides(config, tp: int, vision_tp: bool) -> None:
    tc = _text_config(config)
    what = {"n_heads": tc.n_heads, "hidden_dim": tc.hidden_dim, "vocab_size": tc.vocab_size}
    if vision_tp:
        vc = config.vision_config
        what.update({"vision num_attention_heads": vc.num_attention_heads,
                     "vision intermediate_size": vc.intermediate_size})
    for name, n in what.items():
        if n % tp:
            raise ValueError(f"tp={tp} does not divide {name}={n}")
    nkv = tc.n_kv_groups
    if nkv % tp and tp % nkv:
        raise ValueError(f"tp={tp} must divide n_kv_groups={nkv} or be a multiple of it")


def _rule(name: str, t: torch.Tensor, nkv: int, tp: int, vision_tp: bool) -> tuple:
    """``(dim, parts)`` of the parameter or buffer ``name`` (a
    ``state_dict`` name of the VLM or of a ``CausalLM``)."""
    parts = name.split(".")
    leaf, owner = parts[-1], parts[-2] if len(parts) > 1 else ""
    if "vision_model" in parts:
        if not (vision_tp and "layers" in parts):
            return None, 1
        if owner in _VIS_COLUMN:
            return 0, tp
        if owner in _VIS_ROW and leaf == "weight":
            return 1, tp
        return None, 1
    if leaf == "tok_emb" or owner == "lm_head":
        return 0, tp
    if "blocks" not in parts:
        return None, 1
    if owner in _COLUMN:
        return 0, tp
    if owner in _KV:
        return 0, min(tp, nkv)
    if owner in _ROW:
        if leaf == "scale" and t.dim() == 1:  # int8 per-channel scales follow the out axis
            return None, 1
        return 1, tp
    return None, 1


def param_shardings(config: MLLAMAConfig, mesh: Mesh, model: Optional[nn.Module] = None,
                    vision_tp: bool = False) -> Dict[str, Placement]:
    """``{state_dict name: Placement}`` for every parameter and buffer of
    ``model`` (by default an untied, unquantized model of ``config``, built
    on the ``meta`` device); raises ``ValueError`` where ``tp`` does not
    divide a split axis (heads, intermediate, vocabulary, a row-parallel int4
    leaf's groups)."""
    tp = mesh.shape[AXIS_TP]
    _check_divides(config, tp, vision_tp)
    if model is None:
        from llama32mm_tpu_torch.models.vlm import MllamaForConditionalGeneration

        model = MllamaForConditionalGeneration(config, "meta", tie_weights=False)
    nkv = _text_config(config).n_kv_groups
    out = {}
    named = list(model.named_parameters()) + list(model.named_buffers())
    for name, t in named:
        dim, parts = _rule(name, t, nkv, tp, vision_tp)
        if dim is not None and t.shape[dim] % parts:
            raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does not split into "
                             f"{parts} (tp={tp})")
        out[name] = Placement(mesh, dim, parts if dim is not None else 1)
    return out


def kv_cache_sharding(mesh: Mesh, config) -> Dict[str, tuple]:
    """The KV cache's layout, per tensor the placements of its split dims:
    ``k`` / ``v`` ``[L, B, n_kv, S, hd]`` and the int8 scales ``[L, B, n_kv,
    S]``, batch on ``dp`` and kv heads on ``tp`` (whole heads, as the
    weights)."""
    nkv = _text_config(config).n_kv_groups
    tp = mesh.shape[AXIS_TP]
    both = (Placement(mesh, 1, mesh.shape[AXIS_DP], AXIS_DP),
            Placement(mesh, 2, min(tp, nkv), AXIS_TP))
    return {"k": both, "v": both, "k_scale": both, "v_scale": both}


def _localize(mod: nn.Module, prefix: str, plan: Dict[str, Placement]) -> nn.Module:
    """A copy of ``mod`` whose split tensors are this rank's slices (fresh,
    contiguous), the replicated ones shared with ``mod``."""
    new = copy_module(mod)
    for slot in ("_parameters", "_buffers"):
        for name, t in getattr(mod, slot).items():
            pl = plan.get(prefix + name)
            if t is None or pl is None or pl.dim is None:
                continue
            local = pl.local(t).clone(memory_format=torch.contiguous_format)
            if slot == "_parameters":
                local = nn.Parameter(local, requires_grad=t.requires_grad)
            getattr(new, slot)[name] = set_placement(local, pl)
    for name, child in mod._modules.items():
        if child is not None:
            new._modules[name] = _localize(child, f"{prefix}{name}.", plan)
    return new


def shard_params(model: nn.Module, config: MLLAMAConfig, mesh: Mesh,
                 vision_tp: bool = False) -> nn.Module:
    """This rank's local model: a copy of ``model`` (a VLM, or a
    ``CausalLM`` with its ``LLAMA32Config``) holding its slices of the split
    tensors (``param_shardings``) and sharing the replicated ones, with a
    ``TPShard`` on the decoder (and on the ViT with ``vision_tp``). Float and
    quantized (int8, int4) leaves alike; works on the ``meta`` device too
    (the sharded checkpoint loader builds the local model that way)."""
    if not mesh.member:
        raise ValueError("this rank is not in the mesh")
    if mesh.shape[AXIS_SP] > 1 and mesh.shape[AXIS_PP] > 1:
        raise ValueError("a mesh with both sp > 1 and pp > 1: the pipeline (parallel/pipeline.py) "
                         "does not compose with sequence parallelism, as in the JAX package")
    tp = mesh.shape[AXIS_TP]
    plan = param_shardings(config, mesh, model, vision_tp)
    lm = getattr(model, "language_model", model)
    if lm.model.tp is not None:
        raise ValueError("the model is already sharded")
    new = _localize(model, "", plan)
    tc = _text_config(config)
    vocab_rows = tc.vocab_size // tp
    new_lm = getattr(new, "language_model", new)
    new_lm.model.tp = TPShard(mesh, tc.n_heads // tp, max(1, tc.n_kv_groups // tp),
                              mesh.rank(AXIS_TP) * vocab_rows, vocab_rows)
    if vision_tp:
        heads = config.vision_config.num_attention_heads // tp
        new.vision_model.tp = TPShard(mesh, heads, heads)
    return new


def data_sharding(mesh: Mesh, ndim: int = 2) -> Placement:
    """Batch-sharded tensors: ``[B, ...]`` on ``dp`` (each data-parallel
    rank's rows: ``data_sharding(mesh).local(batch)``). ``ndim`` is kept
    for the JAX signature; the split is dim 0 whatever it is."""
    del ndim
    return Placement(mesh, 0, mesh.shape[AXIS_DP], AXIS_DP)


def seq_data_sharding(mesh: Mesh, ndim: int = 2) -> Placement:
    """Batch- and sequence-sharded token tensors: ``[B, T, ...]`` with the
    rows on ``dp`` and a contiguous chunk of ``T / sp`` tokens on ``sp``
    (``seq_data_sharding(mesh).local(input_ids)``; ``local`` raises when
    ``sp`` does not divide ``T``). Images (``[B, C, H, W]``) take
    ``data_sharding``: every sequence-parallel rank of a row runs its ViT."""
    if ndim < 2:
        raise ValueError("sequence sharding needs at least [B, T]")
    return Placement(mesh, splits=((0, mesh.shape[AXIS_DP], AXIS_DP),
                                   (1, mesh.shape[AXIS_SP], AXIS_SP)))


def lora_shardings(mesh: Mesh, lora_like: dict) -> dict:
    """LoRA adapters: replicated on every rank, as the JAX package keeps
    them (each tensor-parallel rank reads the slice of ``lora_b``'s columns
    or ``lora_a``'s rows that its shard of the base weight needs)."""
    return {k: lora_shardings(mesh, v) if isinstance(v, dict) else Placement(mesh)
            for k, v in lora_like.items()}


def zero1_extend(placement: Placement, shape, axis: str = AXIS_DP) -> Placement:
    """``placement`` (of a tensor whose whole shape is ``shape``) extended
    with ``axis`` on its largest still-unsplit dim that the axis's size
    divides (the first of equals), as the JAX package's ``_zero1_extend``;
    unchanged when the axis has one rank, is already used, or no dim
    qualifies."""
    size = placement.mesh.shape[axis]
    if size == 1 or placement.split_over(axis) > 1:
        return placement
    used = {dim for dim, _, _ in placement.splits}
    best_dim, best = -1, 0
    for d, n in enumerate(shape):
        if d not in used and n % size == 0 and n > best:
            best, best_dim = n, d
    if best_dim < 0:
        return placement
    return placement.extend(best_dim, size, axis)


def zero1_shardings(params: nn.Module, axis: str = AXIS_DP) -> Dict[str, Placement]:
    """ZeRO-1 optimizer-state placements: ``{name: Placement}`` for every
    parameter of ``params`` (a rank's local model from ``shard_params``),
    its tensor-parallel placement (replicated where it has none) extended
    over ``axis`` (``zero1_extend``). Adam moments placed this way hold
    ``1 / |axis|`` of the tensor-parallel layout's bytes on a rank."""
    mesh = mesh_of(params)
    if mesh is None:
        raise ValueError("zero1_shardings: pass the local model of shard_params")
    out = {}
    for name, t in params.named_parameters():
        pl = placement_of(t) or Placement(mesh)
        out[name] = zero1_extend(pl, pl.full_shape(t.shape), axis)
    return out


def tp_of(model: nn.Module) -> Optional[TPShard]:
    """The decoder's ``TPShard`` of a VLM or a ``CausalLM`` (None on one
    device)."""
    return getattr(model, "language_model", model).model.tp


def mesh_of(model: nn.Module) -> Optional[Mesh]:
    """The mesh a sharded model runs on (None on one device)."""
    tp = tp_of(model)
    return None if tp is None else tp.mesh
