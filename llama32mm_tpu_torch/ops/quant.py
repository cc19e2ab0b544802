"""Weights-only quantization for serving (counterpart of
``llama32mm_tpu/ops/quant.py``): the quantized layouts and their math.

Layout: the port keeps nn.Linear's ``[out, in]`` orientation, so every leaf
is the transpose of the JAX package's, byte for byte:

- int8: ``{"q": int8 [N, K], "scale": fp32 [N]}``, symmetric per output
  channel;
- int4: ``{"q4": uint8 [N, K/2], "scale": fp32 [N, K/g]}``, symmetric per
  (output channel, group of ``g`` inputs), two weights per byte in the
  split-half-per-group packing with the ``u = q + 8`` offset. The scales
  are ``[N, K/g]`` (not JAX's ``[K/g, N]`` transposed the other way) so that
  one output row's scales are contiguous for the gemv warp that reads them.

The product with a quantized weight is ``ops/gemv.py::qlinear``; a model is
quantized by ``models/quantize.py::quantize_llama_params``.
"""

from __future__ import annotations

import torch

__all__ = [
    "INT4_MIXED_RECIPE", "dequantize_weight", "is_quantized", "quantize_weight",
    "quantize_weight_int4", "unpack_int4",
]


def _scale(absmax: torch.Tensor, qmax: float, compiled: bool) -> torch.Tensor:
    """``absmax / qmax`` where a channel is nonzero, else 1. ``compiled``
    reproduces the JAX package's jitted quantization bit for bit: XLA turns
    the division by the constant into a product with its fp32 reciprocal.
    Called outside ``jit`` (the JAX package's head and its eager calls) the
    division is exact."""
    s = absmax * torch.tensor(1.0 / qmax, dtype=torch.float32) if compiled else absmax / qmax
    return torch.where(absmax > 0, s, torch.ones_like(absmax))


def quantize_weight(w: torch.Tensor, compiled: bool = False,
                    absmax: torch.Tensor = None) -> dict:
    """``[out, in]`` float → ``{"q": int8 [out, in], "scale": fp32 [out]}``.
    ``absmax`` (fp32 ``[out]``): each channel's absolute maximum when ``w``
    holds only part of its inputs (a row-parallel slice: the maximum over
    the whole row, reduced across the ranks), by default ``w``'s own."""
    w32 = w.to(torch.float32)
    if absmax is None:
        absmax = w32.abs().amax(dim=1)
    scale = _scale(absmax, 127.0, compiled)  # per output channel
    q = torch.clamp(torch.round(w32 / scale[:, None]), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def quantize_weight_int4(w: torch.Tensor, group_size: int = 128, compiled: bool = False) -> dict:
    """``[out, in]`` float → ``{"q4": uint8 [out, in/2], "scale": fp32
    [out, in/g]}``. Byte ``j·g/2 + i`` of a row holds input ``j·g + i`` in
    its low nibble and ``j·g + g/2 + i`` in its high nibble, each stored as
    ``u = q + 8`` with ``q`` in [-7, 7]."""
    co, ci = w.shape
    if ci % group_size or group_size % 2:
        raise ValueError(f"input dim {ci} must be divisible by even group_size {group_size}")
    ng, g2 = ci // group_size, group_size // 2
    w32 = w.to(torch.float32).reshape(co, ng, group_size)
    scale = _scale(w32.abs().amax(dim=-1), 7.0, compiled)  # [out, ng]
    u = torch.clamp(torch.round(w32 / scale[..., None]), -7, 7).to(torch.int32) + 8
    packed = (u[..., :g2] | (u[..., g2:] << 4)).to(torch.uint8)
    return {"q4": packed.reshape(co, ci // 2), "scale": scale}


def unpack_int4(q4: torch.Tensor, ng: int) -> torch.Tensor:
    """Packed ``[N, K/2]`` uint8 → int32 values ``q`` in [-8, 7], ``[N, K]``,
    undoing the split-half-per-group packing."""
    n, half = q4.shape
    b = q4.to(torch.int32).reshape(n, ng, half // ng)
    return torch.cat([(b & 0xF) - 8, (b >> 4) - 8], dim=-1).reshape(n, 2 * half)


def dequantize_weight(qw: dict, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The ``[out, in]`` weight a quantized leaf stands for: ``q · scale`` in
    fp32, one rounding to ``dtype``."""
    scale = qw["scale"]
    if "q4" in qw:
        n, ng = scale.shape
        vals = unpack_int4(qw["q4"], ng).reshape(n, ng, -1).to(torch.float32)
        return (vals * scale[:, :, None]).reshape(n, -1).to(dtype)
    return (qw["q"].to(torch.float32) * scale[:, None]).to(dtype)


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and ("q" in leaf or "q4" in leaf) and "scale" in leaf


# The JAX package's int4 capacity recipe: gate/up and the head (about 2/3 of
# the decoder's weight bytes) in int4; the attention projections and w_down
# in int8.
INT4_MIXED_RECIPE = {
    "w_gate": 4,
    "w_up": 4,
    "lm_head": 4,
    "W_query": 8,
    "W_key": 8,
    "W_value": 8,
    "out_proj": 8,
    "w_down": 8,
}
