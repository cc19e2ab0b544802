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

Not ported (they raise ``NotImplementedError``): ``zero1_params`` /
``zero1_masters`` (the multi-GPU slice).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from llama32mm_tpu_torch.configs import MLLAMAConfig, resolve_dtype
from llama32mm_tpu_torch.models.vlm import MllamaForConditionalGeneration, vlm_forward
from llama32mm_tpu_torch.ops.dispatch import not_in_slice
from llama32mm_tpu_torch.train.accum import accumulate_grads, loss_and_grads
from llama32mm_tpu_torch.train.optim import Adafactor, AdafactorState, Adam
from llama32mm_tpu_torch.utils import st_file

FROZEN_KEYS_VISION = ("vision_model",)


class FullTrainState(NamedTuple):
    params: dict  # name -> trainable master tensor (the model's own parameters)
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


def _compute_twin(model: MllamaForConditionalGeneration, config: MLLAMAConfig,
                  dtype: torch.dtype) -> MllamaForConditionalGeneration:
    """An empty model of the same structure in ``dtype``."""
    device = next(model.parameters()).device
    tied = model.language_model.lm_head is None
    return MllamaForConditionalGeneration(config, device, dtype=dtype, tie_weights=tied)


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
    zero1_params=None,
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
    ``torch.Generator`` for dropout (the ViT's attention dropout)."""
    if zero1_params is not None or zero1_masters:
        not_in_slice("ZeRO optimizer partitioning (zero1_params / zero1_masters)")
    tx = make_optimizer(learning_rate, weight_decay, max_grad_norm, b1, b2, optimizer=optimizer)
    cdt = None if compute_dtype is None else resolve_dtype(compute_dtype)

    def init_state(model: MllamaForConditionalGeneration) -> FullTrainState:
        trainable, frozen = split_trainable(model, freeze_vision)
        module = model
        if cdt is not None and any(p.dtype != cdt for p in model.parameters()):
            module = _compute_twin(model, config, cdt)
            with torch.no_grad():
                for name, p in module.named_parameters():
                    if name in frozen:
                        p.copy_(frozen[name])
        for name, p in module.named_parameters():
            p.requires_grad_(name in trainable)
        return FullTrainState(params=trainable, frozen=frozen, opt_state=tx.init(trainable),
                              step=0, module=module)

    def loss_fn(module, batch, rng):
        return vlm_forward(
            module, config, input_ids=batch["input_ids"], pixel_values=batch.get("pixel_values"),
            attention_mask=batch.get("attention_mask"), labels=batch["labels"],
            dropout_rng=rng, impl=impl, remat=remat, loss_chunk=loss_chunk,
        ).loss

    def train_step(state: FullTrainState, batch: dict, rng=None):
        module = state.module
        compute = dict(module.named_parameters())
        names = list(state.params)
        if compute[names[0]] is not state.params[names[0]]:  # cast the masters in
            with torch.no_grad():
                for name in names:
                    compute[name].copy_(state.params[name])
        wrt = [compute[name] for name in names]
        with torch.enable_grad():
            if accum_steps > 1:
                loss, grads = accumulate_grads(lambda mb: loss_fn(module, mb, rng), wrt, batch,
                                               accum_steps, config.ignore_index)
            else:
                loss, grads = loss_and_grads(loss_fn(module, batch, rng), wrt)
        grads = dict(zip(names, grads))
        opt_state = tx.step(state.params, grads, state.opt_state)
        del grads
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
