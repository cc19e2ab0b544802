"""Full-parameter fine-tuning (counterpart of ``llama32mm_tpu/train/full.py``).

- **Masters and compute dtype.** The model handed to ``init_state`` holds the
  master weights (fp32 typically) and is updated in place. With a
  ``compute_dtype`` other than the masters', the forward and backward run on
  a twin of the model in that dtype: each step casts the trainable masters
  into it, the gradients come back in the compute dtype and the optimizer
  casts each to its master's dtype, as JAX's autodiff through the cast inside
  the differentiated function does. Frozen parameters are cast once.
- **Frozen subtrees.** ``freeze_vision=True`` freezes the vision tower: it
  gets no gradient and no optimizer state, and runs under
  ``torch.no_grad()`` (``models/vlm.py``).
- **Optimizer.** ``clip_by_global_norm`` (optax's rule) then AdamW or,
  with ``optimizer="adafactor"``, optax's Adafactor with the JAX package's
  arguments, stepped one parameter at a time (``optim.py`` beside this
  module); ``learning_rate`` may be a schedule.
- ``remat=True`` and ``loss_chunk=N`` (the chunked loss) for long
  sequences, as in the LoRA step.
- **Meshes.** A model from ``parallel.shard_params`` trains on its mesh,
  each rank given its rows of the batch: the gradients, in the local
  (tensor-parallel) layout, are whole for the rank's slice, except a kv
  head that several ranks hold (``tp`` above ``n_kv_groups``), whose
  partial gradients are summed over those ranks; every gradient is then
  summed over ``sp`` (each sequence-parallel rank's token chunk gives its
  share; the ViT's weights too, whose gradient only the chunk holding the
  image tokens gives) and ``dp``. The moments follow the parameters' layout (each
  ``dp`` rank a copy), the optimizer's norm and statistics sum over the
  mesh (``optim.py``).
- **ZeRO-1** (``zero1_params=`` the local model, ``zero1_axis="dp"``): the
  moments live on ``parallel.zero1_shardings`` (the tensor-parallel layout
  extended over ``dp`` on one more dim), the gradients are reduce-scattered
  into that layout, the update runs on the rank's slice and the updated
  masters are all-gathered back to the tensor-parallel layout.
  ``zero1_masters=True`` keeps the masters themselves ``dp``-sharded
  (``state.params`` holds the slices) and gathers them, cast to the compute
  dtype first, into the compute module every step. As in the JAX package,
  ``zero1_masters`` without ``zero1_params`` changes nothing.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from llama32mm_tpu_torch.configs import MLLAMAConfig, resolve_dtype
from llama32mm_tpu_torch.models.common import copy_module
from llama32mm_tpu_torch.models.vlm import MllamaForConditionalGeneration, vlm_forward
from llama32mm_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_SP,
    AXIS_TP,
    all_gather,
    reduce_scatter,
)
from llama32mm_tpu_torch.parallel.sharding import (
    Placement,
    mesh_of,
    placement_of,
    set_placement,
    zero1_shardings,
)
from llama32mm_tpu_torch.train.accum import accumulate_grads, all_reduce_flat, loss_and_grads
from llama32mm_tpu_torch.train.optim import Adafactor, AdafactorState, Adam
from llama32mm_tpu_torch.utils import st_file

FROZEN_KEYS_VISION = ("vision_model",)


class FullTrainState(NamedTuple):
    params: dict  # name -> trainable master tensor (the model's own; dp slices with zero1_masters)
    frozen: dict  # name -> frozen parameter ({} when everything trains)
    opt_state: object  # AdamState or AdafactorState
    step: int
    module: nn.Module  # the module the forward runs: the model, or its compute-dtype twin

    def full_params(self) -> dict:
        """Every parameter by name (inference, export)."""
        return {**self.frozen, **self.params}


def split_trainable(model: nn.Module, freeze_vision: bool = False):
    """``(trainable, frozen)`` dicts of the model's parameters by name; the
    vision tower is frozen with ``freeze_vision``."""
    frozen_keys = FROZEN_KEYS_VISION if freeze_vision else ()
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        (frozen if name.split(".")[0] in frozen_keys else trainable)[name] = p
    return trainable, frozen


def make_optimizer(learning_rate=1e-5, weight_decay: float = 0.0,
                   max_grad_norm: Optional[float] = 1.0, b1: float = 0.9, b2: float = 0.999,
                   optimizer: str = "adamw"):
    """The optimizer ``make_train_step`` trains with: optax's
    ``clip_by_global_norm(max_grad_norm)`` (when set) then ``adamw``, or
    ``adafactor(learning_rate, multiply_by_parameter_scale=False,
    momentum=None, weight_decay_rate=weight_decay or None)``. Adafactor keeps
    a row and a column vector for each matrix with two dimensions of at
    least 128, in place of AdamW's two full moments."""
    if optimizer == "adamw":
        return Adam(learning_rate, b1=b1, b2=b2, weight_decay=weight_decay,
                    max_grad_norm=max_grad_norm)
    if optimizer == "adafactor":
        return Adafactor(learning_rate, weight_decay_rate=weight_decay or None,
                         max_grad_norm=max_grad_norm)
    raise ValueError(f"optimizer must be 'adamw' or 'adafactor', got {optimizer!r}")


def _compute_twin(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``model``'s module tree (its tensor-parallel state too)
    whose parameters are new, empty, in ``dtype`` (at their local shapes and
    placements); buffers stay shared."""
    new = copy_module(model)
    for name, p in model._parameters.items():
        if p is not None:
            twin = nn.Parameter(torch.empty_like(p, dtype=dtype), requires_grad=False)
            new._parameters[name] = set_placement(twin, placement_of(p))
    for name, child in model._modules.items():
        if child is not None:
            new._modules[name] = _compute_twin(child, dtype)
    return new


def _splits(pl: Optional[Placement], axis: str) -> list:
    """``(dim, parts)`` of each split of ``pl`` along ``axis``."""
    return [] if pl is None else [(d, parts) for d, parts, a in pl.splits if a == axis]


def _slice(t: torch.Tensor, pl: Optional[Placement], axis: str) -> torch.Tensor:
    """The part of ``t`` (a tensor-parallel local tensor) that ``pl`` places
    on this rank along ``axis``: a view."""
    for d, parts in _splits(pl, axis):
        size = t.shape[d] // parts
        t = t.narrow(d, pl._index(parts, axis) * size, size)
    return t


def _kv_partial(pl: Optional[Placement]) -> bool:
    """A tensor-parallel slice that several ``tp`` ranks hold (a kv head at
    ``tp`` above ``n_kv_groups``): each rank's gradient is a partial sum."""
    return pl is not None and pl.split_over(AXIS_TP) > 1 and pl.replicas(AXIS_TP) > 1


def _sum_kv_partial(g: torch.Tensor, pl: Placement) -> torch.Tensor:
    """``g`` summed over the ``tp`` ranks that hold its slice: laid into the
    whole tensor's zeros at the slice, summed over ``tp``, the slice taken."""
    whole = g.new_zeros(pl.full_shape(g.shape))
    pl.local(whole).copy_(g)
    return pl.local(pl.mesh.all_reduce(whole, AXIS_TP)).contiguous()


def make_train_step(
    config: MLLAMAConfig,
    learning_rate=1e-5,
    weight_decay: float = 0.0,
    max_grad_norm: Optional[float] = 1.0,
    b1: float = 0.9,
    b2: float = 0.999,
    freeze_vision: bool = False,
    compute_dtype: Optional[str] = None,
    impl: str = "auto",
    remat: bool = False,
    loss_chunk: Optional[int] = None,
    zero1_params: Optional[nn.Module] = None,
    zero1_axis: str = AXIS_DP,
    zero1_masters: bool = False,
    accum_steps: int = 1,
    optimizer: str = "adamw",
):
    """``(init_state, train_step)`` for full fine-tuning.
    ``init_state(model)`` marks the trainable parameters and returns the
    state; ``train_step(state, batch, rng=None) -> (state, loss)``
    differentiates every non-frozen parameter and takes one optimizer step,
    updating the masters in place. ``batch`` is as in the LoRA step (a
    leading ``[A, ...]`` axis with ``accum_steps=A``); ``rng`` is a
    ``torch.Generator`` for dropout (the ViT's attention dropout). On a
    mesh, and with ``zero1_params`` (the rank's local model from
    ``shard_params``) and ``zero1_masters``, see the module's notes."""
    tx = make_optimizer(learning_rate, weight_decay, max_grad_norm, b1, b2, optimizer=optimizer)
    cdt = None if compute_dtype is None else resolve_dtype(compute_dtype)
    if zero1_axis != AXIS_DP:  # the gradients' dp sum is the reduce-scatter
        raise ValueError(f"zero1_axis must be {AXIS_DP!r} (the gradients' sum), got "
                         f"{zero1_axis!r}")
    z1_shd = None if zero1_params is None else zero1_shardings(zero1_params, zero1_axis)
    z1_masters = zero1_masters and z1_shd is not None

    def opt_layouts(model: nn.Module, names) -> dict:
        """Each trainable parameter's placement in the optimizer's layout
        (None on one device)."""
        mesh = mesh_of(model)
        if mesh is None:
            return dict.fromkeys(names)
        if z1_shd is not None:
            return {name: z1_shd[name] for name in names}
        tensors = dict(model.named_parameters())
        return {name: placement_of(tensors[name]) or Placement(mesh) for name in names}

    def init_state(model: MllamaForConditionalGeneration) -> FullTrainState:
        trainable, frozen = split_trainable(model, freeze_vision)
        module = model
        master_dtype = next(iter(trainable.values())).dtype
        if z1_masters or (cdt is not None and any(p.dtype != cdt for p in model.parameters())):
            module = _compute_twin(model, cdt or master_dtype)
            with torch.no_grad():
                for name, p in module.named_parameters():
                    if name in frozen:
                        p.copy_(frozen[name])
        for name, p in module.named_parameters():
            p.requires_grad_(name in trainable)
        layouts = opt_layouts(model, trainable)
        params = trainable
        opt_params = {name: _slice(p, layouts[name], zero1_axis) for name, p in params.items()}
        if z1_masters:  # the masters' own dp slices
            params = {name: set_placement(p.detach().clone(), layouts[name])
                      for name, p in opt_params.items()}
        opt_state = tx.init(opt_params, layouts=layouts)
        return FullTrainState(params=params, frozen=frozen, opt_state=opt_state, step=0,
                              module=module)

    def loss_fn(module, batch, rng):
        return vlm_forward(
            module, config, input_ids=batch["input_ids"], pixel_values=batch.get("pixel_values"),
            attention_mask=batch.get("attention_mask"), labels=batch["labels"],
            dropout_rng=rng, impl=impl, remat=remat, loss_chunk=loss_chunk,
        ).loss

    def train_step(state: FullTrainState, batch: dict, rng=None):
        module = state.module
        mesh = mesh_of(module)
        compute = dict(module.named_parameters())
        names = list(state.params)
        layouts = opt_layouts(module, names)
        if compute[names[0]] is not state.params[names[0]]:  # cast (and gather) the masters in
            with torch.no_grad():
                for name in names:
                    src = state.params[name]
                    if z1_masters:  # cast first: the gather moves compute-dtype bytes
                        src = src.to(compute[name].dtype)
                        for d, _ in _splits(layouts[name], zero1_axis):
                            src = all_gather(src, mesh, zero1_axis, d)
                    compute[name].copy_(src)
        wrt = [compute[name] for name in names]
        with torch.enable_grad():
            if accum_steps > 1:
                loss, grads = accumulate_grads(lambda mb: loss_fn(module, mb, rng), wrt, batch,
                                               accum_steps, config.ignore_index, mesh)
            else:
                loss, grads = loss_and_grads(loss_fn(module, batch, rng), wrt)
        grads = dict(zip(names, grads))
        if mesh is None:
            opt_state = tx.step(state.params, grads, state.opt_state)
            del grads
            return state._replace(opt_state=opt_state, step=state.step + 1), loss
        for name in names:
            pl = placement_of(compute[name])
            if _kv_partial(pl):
                grads[name] = _sum_kv_partial(grads[name], pl)
        all_reduce_flat([grads[n] for n in names], mesh, AXIS_SP)
        # the data-parallel sum: reduce-scattered into ZeRO-1's slices, else all-reduced
        all_reduce_flat([grads[n] for n in names if not _splits(layouts[n], zero1_axis)], mesh,
                        zero1_axis)
        for name in names:
            for d, _ in _splits(layouts[name], zero1_axis):
                grads[name] = reduce_scatter(grads[name], mesh, zero1_axis, d)
        slices = {name: p if z1_masters else _slice(p, layouts[name], zero1_axis)
                  for name, p in state.params.items()}
        opt_state = tx.step(slices, grads, state.opt_state, layouts=layouts)
        del grads
        if z1_shd is not None and not z1_masters:  # updated slices gathered into the masters
            with torch.no_grad():
                for name, p in state.params.items():
                    part = slices[name]
                    for d, _ in _splits(layouts[name], zero1_axis):
                        part = all_gather(part.contiguous(), mesh, zero1_axis, d)
                    if part is not p:
                        p.copy_(part)
        return state._replace(opt_state=opt_state, step=state.step + 1), loss

    return init_state, train_step


def _moments(opt_state) -> tuple:
    """The optimizer state's tensor dicts by file prefix."""
    if isinstance(opt_state, AdafactorState):
        return (("v_row", opt_state.v_row), ("v_col", opt_state.v_col), ("v", opt_state.v))
    return (("mu", opt_state.mu), ("nu", opt_state.nu))


def save_full_train_state(path: str, state: FullTrainState) -> None:
    """Persist masters, frozen parameters, the optimizer's moments (Adam's
    ``mu``/``nu`` or Adafactor's ``v_row``/``v_col``/``v``), update count and
    step as one safetensors file keyed by name."""
    tensors = {f"params/{n}": t for n, t in state.params.items()}
    tensors.update({f"frozen/{n}": t for n, t in state.frozen.items()})
    for prefix, moments in _moments(state.opt_state):
        tensors.update({f"{prefix}/{n}": t for n, t in moments.items()})
    tensors["count"] = torch.tensor(state.opt_state.count, dtype=torch.int64)
    tensors["step"] = torch.tensor(state.step, dtype=torch.int64)
    st_file.save_file(tensors, path)


def load_full_train_state(path: str, template: FullTrainState) -> FullTrainState:
    """A state saved by ``save_full_train_state``, loaded into ``template``'s
    tensors (a fresh ``init_state(model)``) in place; names, shapes and
    dtypes must match."""
    data = st_file.load_file(path)
    groups = (("params", template.params), ("frozen", template.frozen),
              *_moments(template.opt_state))
    with torch.no_grad():
        for prefix, tensors in groups:
            for name, dst in tensors.items():
                key = f"{prefix}/{name}"
                if key not in data:
                    raise KeyError(f"train-state file is missing {key!r}")
                src = data[key]
                if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                    raise ValueError(f"train-state mismatch at {key}: template "
                                     f"{tuple(dst.shape)} {dst.dtype}, file "
                                     f"{tuple(src.shape)} {src.dtype}")
                dst.copy_(src)
        module = template.module
        compute = dict(module.named_parameters())
        for name, t in template.frozen.items():  # a compute twin holds its own frozen copy
            if compute[name] is not t:
                compute[name].copy_(t)
    opt_state = dataclasses.replace(template.opt_state, count=int(data["count"]))
    return template._replace(opt_state=opt_state, step=int(data["step"]))
