"""Quantizing a port model for serving (counterpart of the JAX package's
``ops/quant.py::quantize_llama_params``): the text decoder's linears, and an
untied head, become ``QuantLinear`` modules holding ``ops/quant.py``'s
layouts."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from llama32mm_tpu_torch.models.common import QuantLinear, copy_module
from llama32mm_tpu_torch.ops.quant import quantize_weight, quantize_weight_int4

_ATT = ("W_query", "W_key", "W_value", "out_proj")
_FF = ("w_gate", "w_up", "w_down")


def quantize_llama_params(
    model: nn.Module,
    quantize_lm_head: bool = True,
    free_originals: bool = False,
    bits: int = 8,
    group_size: int = 128,
    recipe: Optional[dict] = None,
) -> nn.Module:
    """A copy of a VLM (or causal LM) whose text-decoder linears, and an
    untied head, are ``QuantLinear`` modules; every other weight is shared
    with ``model``. A tied head stays float, as do embeddings, norms and the
    vision tower.

    ``bits`` (8 or 4, group ``group_size``) applies to every linear that
    ``recipe`` (weight name → 4 or 8, e.g. ``INT4_MIXED_RECIPE``) does not
    name. Weights are quantized one at a time, so the fp32 intermediate is
    one weight; ``free_originals=True`` frees each float weight once it is
    quantized, so the device never holds both copies of the model (``model``
    is unusable afterwards)."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if recipe:
        bad = set(recipe.values()) - {4, 8}
        if bad:
            raise ValueError(f"recipe bits must be 4 or 8, got {sorted(bad)}")

    def quantized(lin: nn.Module, name: str, compiled: bool = True) -> QuantLinear:
        b = recipe.get(name, bits) if recipe else bits
        with torch.no_grad():
            w = lin.weight
            qw = (quantize_weight_int4(w, group_size, compiled) if b == 4
                  else quantize_weight(w, compiled))
            if free_originals:
                lin.weight.data = torch.empty(0, dtype=w.dtype, device=w.device)
        return QuantLinear(qw)

    lm = getattr(model, "language_model", model)
    new_lm = copy_module(lm)
    new_lm.model = copy_module(lm.model)
    new_lm.model.blocks = copy_module(lm.model.blocks)
    for i, blk in enumerate(lm.model.blocks):
        nb = copy_module(blk)
        nb.att, nb.ff = copy_module(blk.att), copy_module(blk.ff)
        for parent, names in ((nb.att, _ATT), (nb.ff, _FF)):
            for name in names:
                setattr(parent, name, quantized(getattr(parent, name), name))
        new_lm.model.blocks[i] = nb
    if quantize_lm_head and lm.lm_head is not None:
        # the JAX package quantizes its decoder stacks under jit, its head eagerly
        new_lm.lm_head = quantized(lm.lm_head, "lm_head", compiled=False)
    if lm is model:
        return new_lm
    new = copy_module(model)
    new.language_model = new_lm
    return new
