"""Activation-aware weight equalization before quantization (counterpart of
``llama32mm_tpu/ops/awq.py``).

Quantization error is dominated by the weights that multiply large
activations. Scaling those input channels up in the weight, and down in the
op that produces them, before rounding protects them, and each rescale folds
exactly into its neighbour, so the float model computes the same function:

- q/k/v read norm1's output and gate/up read norm2's: a per-channel scale
  folds into the RMSNorm weight (``γ / s`` against ``W · s``);
- w_down reads ``silu(gate) · up``: its scale folds into w_up's output
  channels (``silu(g) · (u / s) @ (s · W_down)``), as silu(g) is untouched;
- the head is not equalized (folding into the final norm would also scale
  a tied embedding).

Calibration is one ordinary forward with ``collect_stats=True``
(``models/language.py``), which returns each layer's per-channel mean
|input| of the decoder linears.

Orientation: the JAX package scales the *rows* of its ``[L, in, out]``
weights by an input-channel scale; the port keeps ``[out, in]`` per layer,
so the same scale multiplies the *columns* (the input dimension, ``dim=1``)
and w_up's output-channel scale its rows (``dim=0``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from llama32mm_tpu_torch.models.common import copy_module


def calibrate_stats(model, config, input_ids: torch.Tensor,
                    pixel_values: Optional[torch.Tensor] = None, attention_mask=None) -> dict:
    """One calibration forward; returns ``{"norm1_absmean": [L, h],
    "norm2_absmean": [L, h], "inter_absmean": [L, I]}`` (fp32). The head
    runs at one position a row only (the statistics come from the decoder
    body; the ``[B, T, vocab]`` logits are never needed)."""
    from llama32mm_tpu_torch.models.vlm import vlm_forward

    b = input_ids.shape[0]
    with torch.no_grad():
        out = vlm_forward(
            model, config, input_ids=input_ids, pixel_values=pixel_values,
            attention_mask=attention_mask, collect_stats=True,
            logits_positions=torch.zeros((b, 1), dtype=torch.int32, device=input_ids.device),
        )
    return out.stats


def _scales(absmean: torch.Tensor, alpha: float) -> torch.Tensor:
    """AWQ's ``s = (E|x|)^α``, normalized per layer to geometric mean 1 (so
    the overall weight magnitude, and the group maxima, stay centred)."""
    a = absmean.float().clamp(min=1e-6) ** alpha
    log_gm = torch.log(a).mean(dim=-1, keepdim=True)
    return a / torch.exp(log_gm)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def awq_equalize(model: nn.Module, stats: dict, alpha: float = 0.5) -> nn.Module:
    """A copy of a VLM (or causal LM) with the activation-aware scales folded
    in; quantize the result with ``quantize_llama_params``. Three exact
    foldings per layer: norm1 ↔ the inputs of q/k/v, norm2 ↔ the inputs of
    gate/up, w_up's outputs ↔ w_down's inputs. Every other weight is shared
    with ``model``, which stays untouched. ``alpha=0.5`` is AWQ's standard
    trade between protecting activations and widening weight ranges."""
    lm = getattr(model, "language_model", model)
    s1 = _scales(stats["norm1_absmean"], alpha)  # [L, h]
    s2 = _scales(stats["norm2_absmean"], alpha)  # [L, h]
    sd = _scales(stats["inter_absmean"], alpha)  # [L, I]

    def inputs(w, s):  # input-channel scaling of [out, in]
        return _param((w.float() * s[None, :]).to(w.dtype))

    def outputs(w, s):  # output-channel scaling of [out, in]
        return _param((w.float() * s[:, None]).to(w.dtype))

    new_lm = copy_module(lm)
    new_lm.model = copy_module(lm.model)
    new_lm.model.blocks = copy_module(lm.model.blocks)
    with torch.no_grad():
        for i, blk in enumerate(lm.model.blocks):
            nb = copy_module(blk)
            nb.att, nb.ff = copy_module(blk.att), copy_module(blk.ff)
            for norm, s in (("norm1", s1[i]), ("norm2", s2[i])):
                new = copy_module(getattr(blk, norm))
                w = new.weight
                new.weight = _param((w.float() / s).to(w.dtype))
                setattr(nb, norm, new)
            for parent, name, w in (
                (nb.att, "W_query", inputs(blk.att.W_query.weight, s1[i])),
                (nb.att, "W_key", inputs(blk.att.W_key.weight, s1[i])),
                (nb.att, "W_value", inputs(blk.att.W_value.weight, s1[i])),
                (nb.ff, "w_gate", inputs(blk.ff.w_gate.weight, s2[i])),
                # w_up takes both: its inputs by the norm2 scales, its outputs
                # by 1 / sd, so that w_down's inputs can take sd
                (nb.ff, "w_up", outputs(inputs(blk.ff.w_up.weight, s2[i]), 1.0 / sd[i])),
                (nb.ff, "w_down", inputs(blk.ff.w_down.weight, sd[i])),
            ):
                lin = copy_module(getattr(parent, name))
                lin.weight = w
                setattr(parent, name, lin)
            new_lm.model.blocks[i] = nb
    if lm is model:
        return new_lm
    new = copy_module(model)
    new.language_model = new_lm
    return new

