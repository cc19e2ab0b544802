"""LoRA fine-tuning (counterpart of ``llama32mm_tpu/train/lora.py``).

The adapter tree is the JAX package's, with torch tensors: ``{"blocks":
{target: {"lora_a" [L, in, r], "lora_b" [L, r, out], "scaling" [L]}},
"lm_head": {...}, "projector": {...}}`` with flat ``[in, r]`` / ``[r, out]``
/ ``[]`` leaves for the head and the projector. Every leaf trains, the
scaling included, as every leaf of the JAX tree is differentiated and
stepped by ``optax.adam``. The base model stays frozen: its parameters do
not require gradients. The step updates the adapters and the Adam moments in
place.

On a mesh (the model from ``parallel.shard_params``, each rank given its
rows of the batch) the adapters stay replicated, as the JAX package keeps
them (``parallel.lora_shardings``); each tensor-parallel rank reads its
slice (``models/language.py``), so the decoder's and the head's adapter
gradients are partial sums, summed over ``tp``, while the projector's is
whole on every rank. Every gradient is then summed over ``dp`` and
``sp`` (each rank's share of the global token mean: under sequence
parallelism a rank's gradient holds its token chunk's share, the
projector's too, which only the chunks holding image tokens give), so
every rank takes the same Adam step.
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
from llama32mm_tpu_torch.parallel.mesh import AXIS_DP, AXIS_SP, AXIS_TP
from llama32mm_tpu_torch.parallel.sharding import mesh_of
from llama32mm_tpu_torch.train.accum import accumulate_grads, all_reduce_flat, loss_and_grads
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


def zero_lora_params(config, rank: int = 16, device="cuda", **kw) -> dict:
    """An identity adapter (B = 0, as at init; A from a generator seeded 0
    on ``device``): entry 0 of a serving bank, so that requests without an
    adapter run the base model exactly. ``kw`` as ``init_lora_params``."""
    gen = torch.Generator(device=device).manual_seed(0)
    return init_lora_params(gen, config, rank=rank, device=device, **kw)


def first_leaf(tree: dict) -> torch.Tensor:
    """The first tensor of a nested adapter tree (or bank)."""
    leaf = next(iter(tree.values()))
    return first_leaf(leaf) if isinstance(leaf, dict) else leaf


def _structure(tree: dict):
    """The keys of an adapter tree and the shapes of its leaves."""
    return tuple((k, _structure(v) if isinstance(v, dict) else tuple(v.shape))
                 for k, v in sorted(tree.items()))


def _stack(trees: Sequence[dict]) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in trees[0].items()}


def stack_adapter_bank(adapters: Sequence[dict]) -> dict:
    """N adapter trees of one structure stacked into a bank (each leaf gains
    a leading ``[N, ...]`` axis) for multi-LoRA serving: the
    continuous-batching server holds one bank and each slot picks its
    adapter by index (``ContinuousBatchingServer(adapter_bank=...)``). All
    adapters share rank and targets; entry 0 is conventionally the identity
    adapter (``zero_lora_params``)."""
    if not adapters:
        raise ValueError("need at least one adapter")
    if len({_structure(a) for a in adapters}) != 1:
        raise ValueError("adapters have mismatched structures (rank/targets must agree)")
    return _stack(adapters)


def gather_adapter_bank(bank: dict, idx) -> dict:
    """Per-row adapters for a batch: ``idx [B]`` picks each row's adapter
    from the bank. Blocks leaves become ``[L, B, in, r]`` (the layer axis
    first, so ``leaf[l]`` is the per-row ``[B, in, r]`` that
    ``models/language.py::maybe_lora`` takes), flat leaves (the head, the
    projector) ``[B, in, r]``. The result is a copy, contiguous."""
    idx = torch.as_tensor(idx, dtype=torch.long, device=first_leaf(bank).device)
    out = {}
    for key, sub in bank.items():
        if key == "blocks":
            out[key] = {name: {leaf: t.transpose(0, 1).index_select(1, idx)
                               for leaf, t in ad.items()} for name, ad in sub.items()}
        else:
            out[key] = {leaf: t.index_select(0, idx) for leaf, t in sub.items()}
    return out


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
            impl=impl, remat=remat, loss_chunk=loss_chunk,
        ).loss

    def train_step(model, state: LoraTrainState, batch: dict, rng=None):
        flat = lora_leaves(state.lora)
        wrt = list(flat.values())
        mesh = mesh_of(model)
        with torch.enable_grad():
            if accum_steps > 1:
                loss, grads = accumulate_grads(lambda mb: loss_fn(model, state.lora, mb, rng),
                                               wrt, batch, accum_steps, config.ignore_index, mesh)
            else:
                loss, grads = loss_and_grads(loss_fn(model, state.lora, batch, rng), wrt)
        # the rank's slices give partial gradients (not the projector's: it is whole)
        all_reduce_flat([g for name, g in zip(flat, grads) if not name.startswith("projector.")],
                        mesh, AXIS_TP)
        for axis in (AXIS_DP, AXIS_SP):
            all_reduce_flat(grads, mesh, axis)
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
