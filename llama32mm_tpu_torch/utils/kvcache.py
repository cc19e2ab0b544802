"""Preallocated KV cache (counterpart of ``llama32mm_tpu/utils/kvcache.py``).

Layout ``[n_layers, batch, n_kv_heads, max_len, head_dim]``, float dtypes
only. Unlike the JAX package's immutable cache, this one is updated in
place: a layer's new keys and values are written into their slots by slice
assignment, and ``pos`` (the number of filled slots) advances once per
forward.
"""

from __future__ import annotations

from typing import Optional

import torch

from llama32mm_tpu_torch.configs import LLAMA32Config
from llama32mm_tpu_torch.ops.dispatch import not_in_slice


class KVCache:
    def __init__(self, k: torch.Tensor, v: torch.Tensor, pos: int = 0):
        self.k = k  # [L, B, n_kv, S_max, hd]
        self.v = v
        self.pos = pos

    @property
    def max_length(self) -> int:
        return self.k.shape[-2]

    def update(self, layer_idx: int, k_new: torch.Tensor, v_new: torch.Tensor):
        """Write ``[B, n_kv, T, hd]`` entries of one layer at slots
        ``pos .. pos+T-1`` and return that layer's full key/value buffers."""
        t = k_new.shape[2]
        if self.pos + t > self.max_length:
            raise ValueError(
                f"KV cache overflow: {self.pos} + {t} > capacity {self.max_length}"
            )
        self.k[layer_idx, :, :, self.pos:self.pos + t] = k_new
        self.v[layer_idx, :, :, self.pos:self.pos + t] = v_new
        return self.k[layer_idx], self.v[layer_idx]

    def advance(self, n: int) -> None:
        self.pos += n


def init_kv_cache(
    config: LLAMA32Config,
    batch_size: int,
    device: torch.device,
    max_length: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
) -> KVCache:
    max_length = max_length or config.max_cache_length
    dtype = dtype or config.torch_dtype
    if not dtype.is_floating_point:
        not_in_slice(f"a {dtype} (quantized) KV cache")
    shape = (config.n_layers, batch_size, config.n_kv_groups, max_length, config.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )
