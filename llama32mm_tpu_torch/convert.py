"""Convert between the JAX package's parameter pytree and the port's modules.

The JAX package stores linears ``[in, out]`` and stacks per-layer leaves as
``[L, ...]``; the port keeps one module per layer and nn.Linear's
``[out, in]``. ``from_jax_params`` takes the JAX tree as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``), transposes the linears
and unstacks the layers; ``to_jax_params`` is its inverse. A tied head is
``{"lm_head": {"weight": None}}`` in the JAX tree and ``lm_head = None``
here. bf16 leaves travel as float32 numpy arrays (numpy has no bf16), which
is exact. ``causal_lm_from_jax`` does the same for a bare causal-LM tree
(``init_causal_lm_params``), e.g. a speculative-decoding draft.

LoRA adapter trees have one layout in both packages (``lora_a [L, in, r]``,
``lora_b [L, r, out]``, ``scaling [L]`` per target under ``"blocks"``, flat
``lm_head`` / ``projector`` adapters): ``lora_from_jax`` and ``lora_to_jax``
only change the array type.

Quantized trees (``quantize_llama_params``): a ``{"q", "scale"}`` or
``{"q4", "scale"}`` leaf stands where the float weight was, stacked
``[L, ...]`` for the decoder linears or single for the head. Each of its
arrays is transposed like the weight (``q [K, N] → [N, K]``, ``q4
[K/2, N] → [N, K/2]``, ``scale [K/g, N] → [N, K/g]``, an int8 ``scale [N]``
as it is) into a ``QuantLinear``; the bytes do not change.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from llama32mm_tpu_torch.configs import LLAMA32Config, MLLAMAConfig
from llama32mm_tpu_torch.models.common import QuantLinear
from llama32mm_tpu_torch.models.language import CausalLM
from llama32mm_tpu_torch.models.vlm import MllamaForConditionalGeneration
from llama32mm_tpu_torch.ops.dispatch import not_in_slice
from llama32mm_tpu_torch.ops.quant import is_quantized

# (port tensor, or a QuantLinear's {"q"|"q4", "scale"} dict; path in the JAX
# tree; layer index or None; transposed?)
Entry = Tuple[torch.Tensor, Tuple[str, ...], Optional[int], bool]
# (module holding a quantizable linear, its attribute, path, layer or None)
Slot = Tuple[torch.nn.Module, str, Tuple[str, ...], Optional[int]]


def _lm_quantizable(lm: CausalLM, prefix: Tuple[str, ...]) -> Iterator[Slot]:
    """The decoder linears and an untied head of a causal LM whose JAX tree
    sits at ``prefix``: the weights ``quantize_llama_params`` may quantize."""
    bp = prefix + ("model", "blocks")
    for l, blk in enumerate(lm.model.blocks):
        for name in ("W_query", "W_key", "W_value", "out_proj"):
            yield blk.att, name, bp + ("att", name, "weight"), l
        yield blk.ff, "w_gate", bp + ("ff", "swiglu", "w_gate"), l
        yield blk.ff, "w_up", bp + ("ff", "swiglu", "w_up"), l
        yield blk.ff, "w_down", bp + ("ff", "w_down", "weight"), l
    if lm.lm_head is not None:
        yield lm, "lm_head", prefix + ("lm_head", "weight"), None


def _quantizable(model: MllamaForConditionalGeneration) -> Iterator[Slot]:
    return _lm_quantizable(model.language_model, ("language_model",))


def _lm_entries(lm: CausalLM, prefix: Tuple[str, ...]) -> Iterator[Entry]:
    mp = prefix + ("model",)
    yield lm.model.tok_emb, mp + ("tok_emb", "weight"), None, False
    bp = mp + ("blocks",)
    for l, blk in enumerate(lm.model.blocks):
        yield blk.norm1.weight, bp + ("norm1", "weight"), l, False
        yield blk.norm2.weight, bp + ("norm2", "weight"), l, False
    yield lm.model.final_norm.weight, mp + ("final_norm", "weight"), None, False
    for parent, name, path, layer in _lm_quantizable(lm, prefix):  # decoder linears, head
        yield getattr(parent, name).weight, path, layer, True


def _entries(model: MllamaForConditionalGeneration) -> Iterator[Entry]:
    vm = model.vision_model
    vp = ("vision_model",)
    yield vm.patch_embedding.weight, vp + ("embeddings", "patch_embedding", "weight"), None, True
    yield vm.position_embedding, vp + ("embeddings", "position_embedding", "weight"), None, False
    for l, layer in enumerate(vm.layers):
        lp = vp + ("layers",)
        for name in ("layernorm1", "layernorm2"):
            norm = getattr(layer, name)
            yield norm.weight, lp + (name, "weight"), l, False
            yield norm.bias, lp + (name, "bias"), l, False
        for group, names in (("self_attn", ("q_proj", "k_proj", "v_proj", "out_proj")),
                             ("mlp", ("fc1", "fc2"))):
            for name in names:
                lin = getattr(layer, name)
                yield lin.weight, lp + (group, name, "weight"), l, True
                yield lin.bias, lp + (group, name, "bias"), l, False
    yield vm.post_layernorm.weight, vp + ("post_layernorm", "weight"), None, False
    yield vm.post_layernorm.bias, vp + ("post_layernorm", "bias"), None, False

    proj = model.multi_modal_projector
    yield proj.weight, ("multi_modal_projector", "linear", "weight"), None, True
    yield proj.bias, ("multi_modal_projector", "linear", "bias"), None, False

    yield from _lm_entries(model.language_model, ("language_model",))


def _check_supported(lm_tree: dict) -> None:
    blocks = lm_tree["model"]["blocks"]
    if "W_qkv" in blocks.get("att", {}) or "w_gateup" in blocks.get("ff", {}):
        not_in_slice("the fused W_qkv / w_gateup layout (models/fuse.py)")


def _quant_linear(leaf: dict, layer: Optional[int], shape, device) -> QuantLinear:
    """A ``QuantLinear`` from a JAX quantized leaf (one layer of a stack)."""
    qw = {}
    for key, arr in leaf.items():
        arr = np.asarray(arr)
        if layer is not None:
            arr = arr[layer]
        qw[key] = torch.from_numpy(np.array(arr.T, order="C")).to(device)
    n, k = shape
    q = qw.get("q", qw.get("q4"))
    if tuple(q.shape) != ((n, k) if "q" in qw else (n, k // 2)) or qw["scale"].shape[0] != n:
        raise ValueError(f"quantized leaf {tuple(q.shape)} / {tuple(qw['scale'].shape)} "
                         f"does not fit a [{n}, {k}] weight")
    return QuantLinear(qw)


def _get(tree: dict, path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def from_jax_params(np_tree: dict, config: MLLAMAConfig, device,
                    dtype: Optional[torch.dtype] = None) -> MllamaForConditionalGeneration:
    """The port's model holding the weights of a JAX parameter tree."""
    _check_supported(np_tree["language_model"])
    tied = np_tree["language_model"]["lm_head"]["weight"] is None
    model = MllamaForConditionalGeneration(config, device, dtype=dtype, tie_weights=tied)
    _fill(np_tree, _quantizable(model), _entries(model), device)
    return model


def causal_lm_from_jax(np_tree: dict, config: LLAMA32Config, device,
                       dtype: Optional[torch.dtype] = None) -> CausalLM:
    """The port's ``CausalLM`` holding a JAX causal-LM tree (``init_causal_lm_params``'s
    layout, ``{"model": ..., "lm_head": ...}``, tied or untied), e.g. a
    speculative-decoding draft."""
    _check_supported(np_tree)
    tied = np_tree["lm_head"]["weight"] is None
    lm = CausalLM(config, device, dtype or config.torch_dtype, tie_weights=tied)
    _fill(np_tree, _lm_quantizable(lm, ()), _lm_entries(lm, ()), device)
    return lm


def _fill(np_tree: dict, quantizable: Iterator[Slot], entries: Iterator[Entry], device) -> None:
    """Copy the tree's leaves into the module's parameters; quantized leaves
    replace their linears with ``QuantLinear`` modules first."""
    with torch.no_grad():
        for parent, name, path, layer in quantizable:
            leaf = _get(np_tree, path)
            if is_quantized(leaf):
                shape = getattr(parent, name).weight.shape
                setattr(parent, name, _quant_linear(leaf, layer, shape, device))
        for param, path, layer, transposed in entries:
            if isinstance(param, dict):  # a QuantLinear, filled above
                continue
            arr = np.asarray(_get(np_tree, path))
            if layer is not None:
                arr = arr[layer]
            if arr.dtype.name == "bfloat16":
                arr = arr.astype(np.float32)
            t = torch.from_numpy(np.array(arr.T if transposed else arr, order="C"))
            if tuple(t.shape) != tuple(param.shape):
                raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)}, expected {tuple(param.shape)}")
            param.copy_(t)


def _set(tree: dict, path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def to_jax_params(model: MllamaForConditionalGeneration) -> dict:
    """The JAX package's parameter tree (nested dicts of numpy arrays)."""
    tree: dict = {}
    stacks: dict = {}
    for param, path, layer, transposed in _entries(model):
        leaves = ([(path + (key,), t) for key, t in param.items()] if isinstance(param, dict)
                  else [(path, param)])
        for leaf_path, t in leaves:
            t = t.detach().to("cpu")
            arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
            arr = arr.T if transposed else arr
            if layer is None:
                _set(tree, leaf_path, np.ascontiguousarray(arr))
            else:
                stacks.setdefault(leaf_path, []).append(arr)
    for path, arrs in stacks.items():
        _set(tree, path, np.stack(arrs))
    if model.language_model.lm_head is None:
        _set(tree, ("language_model", "lm_head", "weight"), None)
    return tree


def _to_torch(arr, device, dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr, order="C")).to(device)
    return t if dtype is None else t.to(dtype)


def lora_from_jax(np_tree: dict, device, dtype: Optional[torch.dtype] = None) -> dict:
    """The port's adapter tree from the JAX package's (numpy leaves); bf16
    leaves come back as fp32 unless ``dtype`` is given. The scaling stays
    fp32."""
    out = {}
    for key, sub in np_tree.items():
        adapters = sub.items() if key == "blocks" else [(None, sub)]
        conv = {name: {leaf: _to_torch(arr, device, None if leaf == "scaling" else dtype)
                       for leaf, arr in ad.items()} for name, ad in adapters}
        out[key] = conv if key == "blocks" else conv[None]
    return out


def lora_to_jax(lora: dict) -> dict:
    """The JAX package's adapter tree (numpy leaves; bf16 as fp32)."""
    def arr(t):
        t = t.detach().to("cpu")
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out = {}
    for key, sub in lora.items():
        if key == "blocks":
            out[key] = {name: {leaf: arr(t) for leaf, t in ad.items()} for name, ad in sub.items()}
        else:
            out[key] = {leaf: arr(t) for leaf, t in sub.items()}
    return out
