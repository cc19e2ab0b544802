"""LoRA fine-tuning (counterpart of ``llama32mm_tpu/train/lora.py``).

The adapter tree is the JAX package's, with torch tensors: ``{"blocks":
{target: {"lora_a" [L, in, r], "lora_b" [L, r, out], "scaling" [L]}},
"lm_head": {...}, "projector": {...}}`` with flat ``[in, r]`` / ``[r, out]``
/ ``[]`` leaves for the head and the projector. Every leaf trains, the
scaling included, as every leaf of the JAX tree is differentiated and
stepped by ``optax.adam``. The base model stays frozen: its parameters do
not require gradients. The step updates the adapters and the Adam moments in
place.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from llama32mm_tpu_torch.configs import LLAMA32Config, MLLAMAConfig
from llama32mm_tpu_torch.models.common import Linear, copy_module
from llama32mm_tpu_torch.models.language import LORA_TARGETS, Dropout, maybe_lora
from llama32mm_tpu_torch.models.vlm import vlm_forward
from llama32mm_tpu_torch.ops.dispatch import not_in_slice
from llama32mm_tpu_torch.train.accum import accumulate_grads, loss_and_grads
from llama32mm_tpu_torch.train.optim import Adam, AdamState
from llama32mm_tpu_torch.utils import st_file

DEFAULT_TARGETS = LORA_TARGETS
LEAVES = ("lora_a", "lora_b", "scaling")

_TARGET_DIMS = {
    "W_query": lambda c: (c.hidden_size, c.n_heads * c.head_dim),
    "W_key": lambda c: (c.hidden_size, c.n_kv_groups * c.head_dim),
    "W_value": lambda c: (c.hidden_size, c.n_kv_groups * c.head_dim),
    "out_proj": lambda c: (c.n_heads * c.head_dim, c.hidden_size),
    "w_gate": lambda c: (c.hidden_size, c.hidden_dim),
    "w_up": lambda c: (c.hidden_size, c.hidden_dim),
    "w_down": lambda c: (c.hidden_dim, c.hidden_size),
}


def _adapter(gen: torch.Generator, lead: tuple, n_in: int, n_out: int, rank: int, alpha: float,
             dtype, device) -> dict:
    bound = 1.0 / math.sqrt(n_in)
    a = torch.empty(*lead, n_in, rank, device=device).uniform_(-bound, bound, generator=gen)
    return {"lora_a": a.to(dtype),
            "lora_b": torch.zeros(*lead, rank, n_out, dtype=dtype, device=device),
            "scaling": torch.full(lead, alpha / rank, dtype=torch.float32, device=device)}


def init_lora_params(
    gen: torch.Generator,
    config,
    rank: int = 16,
    alpha: float = 16.0,
    targets: Sequence[str] = DEFAULT_TARGETS,
    dtype: torch.dtype = torch.float32,
    include_lm_head: bool = True,
    include_projector: bool = False,
    device=None,
) -> dict:
    """Stacked per-layer adapters for the decoder ``targets``, plus (by
    default) an ``lm_head`` adapter and, with ``include_projector`` (which
    needs the full ``MLLAMAConfig``), a projector adapter. A is
    kaiming-uniform ``U(±1/sqrt(in))`` from ``gen`` (a generator on
    ``device``), B is zero, so a fresh adapter leaves the model unchanged;
    ``scaling = alpha / rank``."""
    device = device if device is not None else gen.device
    full = config if isinstance(config, MLLAMAConfig) else None
    text: LLAMA32Config = full.text_config if full is not None else config
    lead = (text.n_layers,)
    lora = {"blocks": {name: _adapter(gen, lead, *_TARGET_DIMS[name](text), rank, alpha, dtype,
                                      device) for name in targets}}
    if include_lm_head:
        lora["lm_head"] = _adapter(gen, (), text.hidden_size, text.vocab_size, rank, alpha, dtype,
                                   device)
    if include_projector:
        if full is None:
            raise ValueError("include_projector=True requires a full MLLAMAConfig")
        lora["projector"] = _adapter(gen, (), full.vision_config.hidden_size, text.hidden_size,
                                     rank, alpha, dtype, device)
    return lora


def lora_leaves(lora: dict) -> dict:
    """``{name: tensor}`` with the adapter file's names
    (``blocks.{target}.{leaf}``, ``lm_head.{leaf}``, ``projector.{leaf}``)."""
    flat = {}
    for name, ad in lora.get("blocks", {}).items():
        for leaf in LEAVES:
            flat[f"blocks.{name}.{leaf}"] = ad[leaf]
    for extra in ("lm_head", "projector"):
        if extra in lora:
            for leaf in LEAVES:
                flat[f"{extra}.{leaf}"] = lora[extra][leaf]
    return flat


def _unflatten(flat: dict) -> dict:
    out: dict = {"blocks": {}}
    for key, t in flat.items():
        parts = key.split(".")
        if parts[0] == "blocks":
            out["blocks"].setdefault(parts[1], {})[parts[2]] = t
        else:
            out.setdefault(parts[0], {})[parts[1]] = t
    return out


def stack_adapter_bank(adapters: Sequence[dict]) -> dict:
    """Not ported: multi-LoRA banks belong to the continuous-batching server
    (ROADMAP.md, queue 1)."""
    not_in_slice("adapter banks (stack_adapter_bank), with the server slice")


def gather_adapter_bank(bank: dict, idx) -> dict:
    """Not ported (see ``stack_adapter_bank``)."""
    not_in_slice("adapter banks (gather_adapter_bank), with the server slice")


class Linear_LORA(nn.Module):
    """A frozen base linear (``weight [out, in]``) with a trainable adapter
    (``lora_a [in, r]``, ``lora_b [r, out]``) and input dropout, the object
    form of the JAX package's ``Linear_LORA``: A and the base weight are
    ``U(±1/sqrt(in))``, B ``U(±1/sqrt(r))``."""

    def __init__(self, in_dim: int, out_dim: int, rank: int, alpha: float, dropout: float,
                 gen: torch.Generator, device=None, dtype=torch.float32):
        super().__init__()
        device = device if device is not None else gen.device
        self.rank, self.alpha, self.dropout = rank, alpha, dropout
        bound, b_bound = 1.0 / math.sqrt(in_dim), 1.0 / math.sqrt(rank)

        def uniform(*shape, b):
            t = torch.empty(*shape, device=device).uniform_(-b, b, generator=gen).to(dtype)
            return t

        self.weight = nn.Parameter(uniform(out_dim, in_dim, b=bound), requires_grad=False)
        self.lora_a = nn.Parameter(uniform(in_dim, rank, b=bound))
        self.lora_b = nn.Parameter(uniform(rank, out_dim, b=b_bound))

    def forward(self, x: torch.Tensor, dropout_seed: Optional[int] = None) -> torch.Tensor:
        adapter = {"lora_a": self.lora_a, "lora_b": self.lora_b,
                   "scaling": torch.tensor(self.alpha / self.rank, device=x.device)}
        dropout = None if dropout_seed is None else Dropout(self.dropout, dropout_seed)
        return maybe_lora(x, torch.matmul(x, self.weight.t()), adapter, dropout=dropout)


def _merged(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scaling) -> nn.Parameter:
    """``W + scaling * (A @ B)^T`` in the port's ``[out, in]`` layout, computed
    in the adapters' precision and rounded to W's dtype."""
    with torch.no_grad():
        merged = (w + scaling * torch.matmul(a, b).t()).to(w.dtype)
    return nn.Parameter(merged, requires_grad=False)


def merge_lora_into_params(model: nn.Module, lora: dict) -> nn.Module:
    """A copy of the VLM with the adapters folded into its weights
    (``W' = W + scaling * A @ B``); weights without an adapter stay shared
    with ``model``. A merged tied head becomes an untied ``lm_head`` (the
    delta breaks the embedding share)."""
    new = copy_module(model)
    lm = new.language_model = copy_module(model.language_model)
    lm.model = copy_module(model.language_model.model)
    lm.model.blocks = copy_module(model.language_model.model.blocks)
    for l, blk in enumerate(model.language_model.model.blocks):
        nb = copy_module(blk)
        nb.att, nb.ff = copy_module(blk.att), copy_module(blk.ff)
        for name, ad in lora.get("blocks", {}).items():
            parent = nb.att if name in ("W_query", "W_key", "W_value", "out_proj") else nb.ff
            lin = copy_module(getattr(parent, name))
            lin.weight = _merged(lin.weight, ad["lora_a"][l], ad["lora_b"][l], ad["scaling"][l])
            setattr(parent, name, lin)
        lm.model.blocks[l] = nb
    if "lm_head" in lora:
        ad = lora["lm_head"]
        head = lm.lm_head
        w = lm.model.tok_emb if head is None else head.weight
        if head is None:
            hidden, vocab = lm.model.tok_emb.shape[1], lm.model.tok_emb.shape[0]
            head = Linear(hidden, vocab, False, w.device, w.dtype)
        else:
            head = copy_module(head)
        head.weight = _merged(w, ad["lora_a"], ad["lora_b"], ad["scaling"])
        lm.lm_head = head
    if "projector" in lora:
        ad = lora["projector"]
        proj = new.multi_modal_projector = copy_module(model.multi_modal_projector)
        proj.weight = _merged(proj.weight, ad["lora_a"], ad["lora_b"], ad["scaling"])
    return new


class LoraTrainState(NamedTuple):
    lora: dict
    opt_state: AdamState
    step: int


def make_lora_train_step(
    config: MLLAMAConfig,
    learning_rate=1e-4,
    lora_dropout: float = 0.0,
    impl: str = "auto",
    remat: bool = False,
    loss_chunk: Optional[int] = None,
    accum_steps: int = 1,
):
    """``(init_state, train_step)``. ``train_step(model, state, batch,
    rng=None) -> (state, loss)`` differentiates only the adapters (the base
    model is frozen) and takes one ``optax.adam(learning_rate)`` step.
    ``batch``: ``input_ids``, ``labels`` and optionally ``pixel_values`` and
    ``attention_mask``; with ``accum_steps=A`` each carries a leading ``[A,
    ...]`` microbatch axis and the gradients are valid-target-weighted
    (``train/accum.py``). ``rng`` is a ``torch.Generator`` for the dropout
    (used when ``lora_dropout > 0``)."""
    if loss_chunk is not None:
        not_in_slice("loss_chunk")
    tx = Adam(learning_rate)

    def init_state(lora: dict) -> LoraTrainState:
        flat = lora_leaves(lora)
        for t in flat.values():
            t.requires_grad_(True)
        return LoraTrainState(lora=lora, opt_state=tx.init(flat), step=0)

    def loss_fn(model, lora, batch, rng):
        return vlm_forward(
            model, config, input_ids=batch["input_ids"], pixel_values=batch.get("pixel_values"),
            attention_mask=batch.get("attention_mask"), labels=batch["labels"], lora=lora,
            dropout_rng=rng if lora_dropout > 0.0 else None, lora_dropout=lora_dropout,
            impl=impl, remat=remat,
        ).loss

    def train_step(model, state: LoraTrainState, batch: dict, rng=None):
        flat = lora_leaves(state.lora)
        wrt = list(flat.values())
        with torch.enable_grad():
            if accum_steps > 1:
                loss, grads = accumulate_grads(lambda mb: loss_fn(model, state.lora, mb, rng),
                                               wrt, batch, accum_steps, config.ignore_index)
            else:
                loss, grads = loss_and_grads(loss_fn(model, state.lora, batch, rng), wrt)
        opt_state = tx.step(flat, dict(zip(flat, grads)), state.opt_state)
        return LoraTrainState(lora=state.lora, opt_state=opt_state, step=state.step + 1), loss

    return init_state, train_step


def lora_train_step(model, state, batch, rng, config, **kw):
    """One step with a step function built for the call (prefer
    ``make_lora_train_step`` for loops)."""
    return make_lora_train_step(config, **kw)[1](model, state, batch, rng)


# ---------------------------------------------------------------------------
# Train state (adapters + Adam moments + step) and adapter-only files
# ---------------------------------------------------------------------------


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save_train_state(path: str, state: LoraTrainState) -> None:
    """Persist adapters, Adam moments, update count and step, so fine-tuning
    resumes exactly."""
    arrays = {"step": np.asarray(state.step), "count": np.asarray(state.opt_state.count)}
    for name, t in lora_leaves(state.lora).items():
        arrays[f"lora/{name}"] = _np(t)
        arrays[f"mu/{name}"] = _np(state.opt_state.mu[name])
        arrays[f"nu/{name}"] = _np(state.opt_state.nu[name])
    np.savez_compressed(_npz_path(path), **arrays)


def load_train_state(path: str, template: LoraTrainState) -> LoraTrainState:
    """A state saved by ``save_train_state``, loaded into ``template``'s
    tensors (e.g. a fresh ``init_state(lora)``) in place."""
    data = np.load(_npz_path(path))
    with torch.no_grad():
        for name, t in lora_leaves(template.lora).items():
            for prefix, dst in (("lora", t), ("mu", template.opt_state.mu[name]),
                                ("nu", template.opt_state.nu[name])):
                arr = data[f"{prefix}/{name}"]
                if tuple(arr.shape) != tuple(dst.shape):
                    raise ValueError(f"train-state shape mismatch at {prefix}/{name}: "
                                     f"{tuple(dst.shape)} vs {arr.shape}")
                dst.copy_(torch.from_numpy(arr))
    opt_state = AdamState(count=int(data["count"]), mu=template.opt_state.mu,
                          nu=template.opt_state.nu)
    return LoraTrainState(lora=template.lora, opt_state=opt_state, step=int(data["step"]))


def save_lora_adapters(path: str, lora: dict) -> None:
    """The adapters alone, as a safetensors file with the JAX package's key
    names (``blocks.{target}.{lora_a|lora_b|scaling}``, ``lm_head.*``,
    ``projector.*``); either package loads the other's file."""
    st_file.save_file(lora_leaves(lora), path)


def load_lora_adapters(path: str, device) -> dict:
    """An adapter tree from ``save_lora_adapters`` (or the JAX package's),
    on ``device``."""
    return _unflatten({k: t.to(device) for k, t in st_file.load_file(path).items()})
