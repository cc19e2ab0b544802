"""Rotary position embeddings (counterpart of ``llama32mm_tpu/ops/rope.py``).

Inverse frequencies and angles in fp32, cos/sin cast to the activation
dtype, half-split ``rotate_half``. llama-3 frequency scaling applies only
when asked (``apply_rope_scaling``, off by default: PARITY.md row 4).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def rope_inv_freq(head_dim: int, base: float, scaling: Optional[dict] = None,
                  device=None) -> torch.Tensor:
    """fp32 ``[head_dim // 2]`` inverse frequencies."""
    exponents = torch.arange(0, head_dim, 2, device=device).float()
    inv_freq = 1.0 / (base ** (exponents / head_dim))
    if scaling:
        factor = scaling["factor"]
        low = scaling["low_freq_factor"]
        high = scaling["high_freq_factor"]
        orig_ctx = scaling["original_context_length"]
        wavelen = 2.0 * math.pi / inv_freq
        low_wavelen = orig_ctx / low
        high_wavelen = orig_ctx / high
        smooth = (orig_ctx / wavelen - low) / (high - low)
        scaled = torch.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        mid = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        is_mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        inv_freq = torch.where(is_mid, mid, scaled)
    return inv_freq


def rope_cos_sin(
    position_ids: torch.Tensor,  # [B, T] int
    head_dim: int,
    base: float,
    dtype: torch.dtype = torch.float32,
    scaling: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)``, each ``[B, T, head_dim]`` in ``dtype``."""
    inv_freq = rope_inv_freq(head_dim, base, scaling, device=position_ids.device)
    freqs = position_ids.float()[..., None] * inv_freq[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """RoPE on q/k ``[B, heads, T, head_dim]`` with cos/sin ``[B, T, head_dim]``
    broadcast over heads."""
    cos = cos[:, None]
    sin = sin[:, None]
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
