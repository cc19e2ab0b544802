"""Plain-ViT vision encoder (counterpart of ``llama32mm_tpu/models/vision.py``).

Patchify + one matmul for the patch embedding ((C, Ph, Pw) order, a strided
conv's layout) plus learned positions, no CLS token; pre-norm blocks with
standard residuals; LayerNorm computed as the JAX function computes it;
exact (erf) GELU; non-causal multi-head attention through the flash kernel
with every key valid. The linears are plain ``torch.matmul`` GEMMs, as the
JAX package leaves them to XLA.

Training with attention dropout (``dropout_rng`` given and
``config.attention_dropout > 0``) needs the attention weights themselves, so
each layer then takes the explicit form, as the JAX package does:
``softmax(q·kᵀ·hd^-0.5)`` in fp32, cast back, inverted dropout on the
weights from one generator a layer (seeded from ``dropout_rng``), then the
product with v. Inference stays on flash and is deterministic. The dropout
bits are not JAX's; only the rule is.

Tensor parallelism (``shard_params(..., vision_tp=True)``): a tower with a
``TPShard`` holds its rank's heads and ``fc1`` columns; the layer norms'
outputs pass through ``f`` into the column-parallel ``q/k/v_proj`` and
``fc1``, and ``out_proj`` and ``fc2`` sum their partial products with ``g``
and add their bias once, after the sum (``parallel/mesh.py``), so the tower
trains as it serves. The attention dropout's mask is drawn at the one-device
shape ``[B, heads, N, N]`` and sliced to the rank's batch rows (``dp``) and
heads (``tp``), so a sharded step equals the one-device step.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from llama32mm_tpu_torch.configs import VisionEncoderConfig
from llama32mm_tpu_torch.models.common import Linear, Norm, empty_param
from llama32mm_tpu_torch.ops.attention import AttnMask, gqa_attention


def layer_norm(x: torch.Tensor, norm: Norm, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * norm.weight + norm.bias


def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """``[B, C, H, W] → [B, num_patches, C·P·P]`` in (C, Ph, Pw) order."""
    b, c, hgt, wid = pixel_values.shape
    p = patch_size
    nh, nw = hgt // p, wid // p
    x = pixel_values.reshape(b, c, nh, p, nw, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, nh * nw, c * p * p)


def _affine(x: torch.Tensor, lin: Linear) -> torch.Tensor:
    return torch.matmul(x, lin.weight.t()) + lin.bias


def _row_affine(x: torch.Tensor, lin: Linear, tp) -> torch.Tensor:
    """A row-parallel linear: the ranks' partial products summed, then the
    bias, added once."""
    if tp is None:
        return _affine(x, lin)
    return tp.reduce(torch.matmul(x, lin.weight.t())) + lin.bias


def dropout_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rate: float,
                      seed: int, rows: Optional[tuple] = None,
                      heads: Optional[tuple] = None) -> torch.Tensor:
    """Training attention with dropout on the weights (the JAX package's
    explicit ``_vit_attention`` branch): ``[B, heads, N, hd]`` in and out.
    ``rows`` and ``heads``: ``(start, total)`` of a data-parallel rank's
    batch rows and a tensor-parallel rank's heads, the mask drawn for all of
    them and sliced."""
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype)
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    weights = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    gen = torch.Generator(device=q.device).manual_seed(seed)
    shape = list(weights.shape)
    for dim, part in ((0, rows), (1, heads)):
        if part is not None:
            shape[dim] = part[1]
    keep = torch.rand(shape, generator=gen, device=q.device) < 1.0 - rate
    for dim, part in ((0, rows), (1, heads)):
        if part is not None:
            keep = keep.narrow(dim, part[0], weights.shape[dim])
    weights = torch.where(keep, weights / (1.0 - rate), torch.zeros((), dtype=weights.dtype))
    return torch.matmul(weights.to(q.dtype), v)


class VisionBlock(nn.Module):
    def __init__(self, config: VisionEncoderConfig, device, dtype):
        super().__init__()
        d, inter = config.hidden_size, config.intermediate_size
        self.layernorm1 = Norm(d, True, device, dtype)
        self.q_proj = Linear(d, d, True, device, dtype)
        self.k_proj = Linear(d, d, True, device, dtype)
        self.v_proj = Linear(d, d, True, device, dtype)
        self.out_proj = Linear(d, d, True, device, dtype)
        self.layernorm2 = Norm(d, True, device, dtype)
        self.fc1 = Linear(d, inter, True, device, dtype)
        self.fc2 = Linear(inter, d, True, device, dtype)

    def attention(self, x: torch.Tensor, config: VisionEncoderConfig, impl: str,
                  dropout: Optional[tuple] = None, tp=None) -> torch.Tensor:
        b, n, d = x.shape
        heads, hd = config.num_attention_heads, config.head_dim
        if tp is not None:
            heads = tp.heads

        def split(t):
            return t.reshape(b, n, heads, hd).transpose(1, 2)

        if tp is not None:
            x = tp.copy_in(x)
        q = split(_affine(x, self.q_proj))
        k = split(_affine(x, self.k_proj))
        v = split(_affine(x, self.v_proj))
        if dropout is None:
            every_key = AttnMask(torch.ones(b, n, dtype=torch.int32, device=x.device), 0)
            ctx = gqa_attention(q, k, v, every_key, causal=False, impl=impl)
        else:
            ctx = dropout_attention(q, k, v, *dropout)
        return _row_affine(ctx.transpose(1, 2).reshape(b, n, heads * hd), self.out_proj, tp)

    def forward(self, h: torch.Tensor, config: VisionEncoderConfig, impl: str,
                dropout: Optional[tuple] = None, tp=None) -> torch.Tensor:
        """``dropout``: ``dropout_attention``'s ``(rate, seed, rows, heads)``, or None;
        ``tp``: the tower's ``TPShard``, or None."""
        eps = config.layer_norm_eps
        h = h + self.attention(layer_norm(h, self.layernorm1, eps), config, impl, dropout, tp)
        x = layer_norm(h, self.layernorm2, eps)
        y = F.gelu(_affine(x if tp is None else tp.copy_in(x), self.fc1))
        return h + _row_affine(y, self.fc2, tp)


class VisionEncoder(nn.Module):
    """``[B, C, H, W] → [B, num_patches, hidden_size]``."""

    tp = None  # a TPShard when the tower is tensor-parallel (vision_tp)

    def __init__(self, config: VisionEncoderConfig, device, dtype):
        super().__init__()
        self.config = config
        d = config.hidden_size
        fan_in = config.num_channels * config.patch_size**2
        self.patch_embedding = Linear(fan_in, d, False, device, dtype)
        self.position_embedding = empty_param(config.num_patches, d, device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            VisionBlock(config, device, dtype) for _ in range(config.num_hidden_layers)
        )
        self.post_layernorm = Norm(d, True, device, dtype)

    def init_(self, gen: torch.Generator) -> None:
        """The JAX package's ``init_vision_params`` distributions."""
        self.patch_embedding.init_(gen)
        self.position_embedding.normal_(generator=gen)
        for layer in self.layers:
            for mod in layer.children():
                if isinstance(mod, Linear):
                    mod.init_(gen)
                else:
                    mod.init_()
        self.post_layernorm.init_()

    def forward(self, pixel_values: torch.Tensor, impl: str = "auto",
                dropout_rng: Optional[torch.Generator] = None,
                attention_dropout: Optional[float] = None,
                rows: Optional[tuple] = None) -> torch.Tensor:
        """``dropout_rng`` turns on training attention dropout at
        ``attention_dropout`` (the caller's config's rate; this tower's by
        default), a seed a layer drawn from the generator; ``rows`` as in
        ``dropout_attention``."""
        cfg = self.config
        rate = cfg.attention_dropout if attention_dropout is None else attention_dropout
        patches = patchify(pixel_values, cfg.patch_size)
        h = torch.matmul(patches, self.patch_embedding.weight.t())
        h = h + self.position_embedding[None].to(h.dtype)
        drops = [None] * len(self.layers)
        if dropout_rng is not None and rate > 0.0:
            tp = self.tp
            heads = None if tp is None else (tp.rank * tp.heads, tp.size * tp.heads)
            seeds = torch.randint(0, 2**62, (len(self.layers),), generator=dropout_rng,
                                  device=dropout_rng.device).tolist()
            drops = [(rate, seed, rows, heads) for seed in seeds]
        for layer, drop in zip(self.layers, drops):
            h = layer(h, cfg, impl, drop, self.tp)
        return layer_norm(h, self.post_layernorm, cfg.layer_norm_eps)



def init_vision_params(config: VisionEncoderConfig, device, gen: torch.Generator,
                       dtype: torch.dtype = torch.float32) -> VisionEncoder:
    """A random-init tower with the JAX package's ``init_vision_params``
    distributions, drawn from ``gen`` (a generator on ``device``)."""
    tower = VisionEncoder(config, device, dtype)
    with torch.no_grad():
        tower.init_(gen)
    return tower


def vision_encoder_forward(model: VisionEncoder, config: VisionEncoderConfig,
                           pixel_values: torch.Tensor, impl: str = "auto",
                           dropout_rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """The JAX package's ``vision_encoder_forward``: ``[B, C, H, W] →
    [B, num_patches, D]``; ``dropout_rng`` turns on the attention dropout at
    ``config.attention_dropout``."""
    return model(pixel_values, impl=impl, dropout_rng=dropout_rng,
                 attention_dropout=config.attention_dropout)
