"""Preallocated KV cache (counterpart of ``llama32mm_tpu/utils/kvcache.py``).

Layout ``[n_layers, batch, n_kv_heads, max_len, head_dim]``, in a float dtype
or, in the int8 serving mode, int8 with fp32 per-position scales
``[n_layers, batch, n_kv_heads, max_len]``. Unlike the JAX package's
immutable cache, this one is updated in place: a layer's new keys and values
are written into their slots by slice assignment, and ``pos`` (the number of
filled slots) advances once per forward.

Per-row write offsets (``update_stacked`` / ``update_stacked_scales`` of the
JAX package with a ``[B]`` position): ``pos`` may be an int64 ``[B]`` tensor
on the cache's device, and row ``b``'s ``T`` new entries then land at
``pos[b] .. pos[b]+T-1`` (one scatter per tensor and layer), the int8 scales
with them. Such a cache belongs to the continuous-batching server, which owns
``pos``: it clamps an idle slot's offset to ``S-1`` and advances the rows
itself; ``advance`` refuses a per-row cache.

``slot(b)`` is a one-row view of the batch cache at offset 0: a forward
through it writes row ``b`` of the batch tensors in place. The server admits
a request by prefilling straight into its slot's view (chunked admission:
``C`` tokens at a time, the view's ``pos`` at the chunk's offset), so there
is no scratch cache to splice into the batch, as the JAX package has.
"""

from __future__ import annotations

from typing import Optional

import torch

from llama32mm_tpu_torch.configs import LLAMA32Config

# fp32(1/127) as a 0-dim host tensor: it enters a CUDA product as a kernel
# argument, with no host-to-device copy and so no stream synchronization.
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def quantize_kv(x: torch.Tensor):
    """``[..., hd]`` float → (int8 ``[..., hd]``, fp32 scale ``[...]``):
    symmetric per-position absmax, ``scale = max(absmax, 1e-6) / 127``. The
    JAX package runs this only inside its compiled decoder, where XLA divides
    by 127 as a product with the fp32 reciprocal; so does this, bit for bit."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(x32.abs().amax(dim=-1), min=1e-6) * _INV_127
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def update_layer_cache(k_layer: torch.Tensor, v_layer: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor, pos: int):
    """Write ``[B, n_kv, T, hd]`` entries into one layer's ``[B, n_kv,
    S_max, hd]`` buffers at slots ``pos .. pos+T-1``, in place (the JAX
    package's ``update_layer_cache``, which returns new arrays); returns
    the buffers."""
    slots = slice(pos, pos + k_new.shape[2])
    k_layer[:, :, slots] = k_new
    v_layer[:, :, slots] = v_new
    return k_layer, v_layer


def _row_slots(pos: torch.Tensor, t: int) -> torch.Tensor:
    """``[B, T]``: row ``b``'s slots ``pos[b] .. pos[b]+t-1``."""
    idx = pos.long()[:, None]
    return idx + torch.arange(t, device=idx.device) if t > 1 else idx


def update_stacked(k_all: torch.Tensor, v_all: torch.Tensor, k_new: torch.Tensor,
                   v_new: torch.Tensor, layer_idx: int, pos):
    """One layer's write into the stacked ``[L, B, n_kv, S_max, hd]`` cache,
    in place (the JAX package's ``update_stacked``): at slot ``pos`` (an
    int), or with ``pos`` an int64 ``[B]`` tensor row ``b``'s ``T`` entries
    at ``pos[b] .. pos[b]+T-1`` (one scatter per tensor). Returns the
    stacked buffers."""
    k_l, v_l = k_all[layer_idx], v_all[layer_idx]
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        b, nkv, t, hd = k_new.shape
        idx = _row_slots(pos, t)[:, None, :, None].expand(b, nkv, t, hd)
        k_l.scatter_(2, idx, k_new.to(k_l.dtype))
        v_l.scatter_(2, idx, v_new.to(v_l.dtype))
    else:
        update_layer_cache(k_l, v_l, k_new, v_new, int(pos))
    return k_all, v_all


class KVCache:
    def __init__(self, k: torch.Tensor, v: torch.Tensor, pos: int = 0,
                 k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None):
        self.k = k  # [L, B, n_kv, S_max, hd]
        self.v = v
        self.pos = pos
        # int8 mode: per-(layer, batch, head, position) scales [L, B, n_kv, S_max]
        self.k_scale = k_scale
        self.v_scale = v_scale

    @property
    def max_length(self) -> int:
        return self.k.shape[-2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def per_row(self) -> bool:
        return isinstance(self.pos, torch.Tensor)

    def slot(self, b: int) -> "KVCache":
        """Row ``b`` as a one-row cache at offset 0, sharing the storage."""
        rows = slice(b, b + 1)
        scales = ((None, None) if not self.quantized
                  else (self.k_scale[:, rows], self.v_scale[:, rows]))
        return KVCache(self.k[:, rows], self.v[:, rows], 0, *scales)

    def update(self, layer_idx: int, k_new: torch.Tensor, v_new: torch.Tensor):
        """Write ``[B, n_kv, T, hd]`` entries of one layer at slots
        ``pos .. pos+T-1`` (per row with a ``[B]`` ``pos``; quantized first in
        the int8 mode) and return that layer's full buffers ``(k, v, k_scale,
        v_scale)``; the scales are None in a float cache."""
        b, nkv, t, _ = k_new.shape
        if self.quantized:
            k_new, ks = quantize_kv(k_new)
            v_new, vs = quantize_kv(v_new)
        if not self.per_row and self.pos + t > self.max_length:
            raise ValueError(
                f"KV cache overflow: {self.pos} + {t} > capacity {self.max_length}"
            )
        update_stacked(self.k, self.v, k_new, v_new, layer_idx, self.pos)
        k_l, v_l = self.k[layer_idx], self.v[layer_idx]
        if not self.quantized:
            return k_l, v_l, None, None
        ks_l, vs_l = self.k_scale[layer_idx], self.v_scale[layer_idx]
        if self.per_row:
            sidx = _row_slots(self.pos, t)[:, None, :].expand(b, nkv, t)
            ks_l.scatter_(2, sidx, ks)
            vs_l.scatter_(2, sidx, vs)
        else:
            ks_l[:, :, self.pos:self.pos + t] = ks
            vs_l[:, :, self.pos:self.pos + t] = vs
        return k_l, v_l, ks_l, vs_l

    def advance(self, n: int) -> None:
        if self.per_row:
            raise ValueError("a per-row cache's offsets belong to its caller; advance them there")
        self.pos += n


def init_kv_cache(
    config: LLAMA32Config,
    batch_size: int,
    device: torch.device,
    max_length: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    n_kv_heads: Optional[int] = None,
) -> KVCache:
    """``dtype=torch.int8`` allocates the quantized serving cache: int8 slots
    plus fp32 per-position scales (half the bytes of a bf16 cache).
    ``n_kv_heads``: a tensor-parallel rank's kv heads (``TPShard.kv_heads``),
    by default the config's."""
    max_length = max_length or config.max_cache_length
    dtype = dtype or config.torch_dtype
    if not (dtype.is_floating_point or dtype == torch.int8):
        raise ValueError(f"KV cache dtype must be a float dtype or torch.int8, got {dtype}")
    shape = (config.n_layers, batch_size, n_kv_heads or config.n_kv_groups, max_length,
             config.head_dim)
    k_scale = v_scale = None
    if dtype == torch.int8:
        k_scale = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        v_scale = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        k_scale=k_scale,
        v_scale=v_scale,
    )
