"""Model configurations.

The same dataclasses, field names and defaults as ``llama32mm_tpu/configs.py``
so that a config built for one package reads the same in the other. The only
difference: ``torch_dtype`` resolves the ``dtype`` string to a ``torch.dtype``
(the JAX package's ``jnp_dtype``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Tuple

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"Unknown dtype {name!r}; expected one of {sorted(_DTYPES)}")


# llama-3 RoPE scaling parameters, stored but applied only with
# apply_rope_scaling=True (PARITY.md row 4).
DEFAULT_ROPE_FREQ: Tuple[Tuple[str, float], ...] = (
    ("factor", 32.0),
    ("low_freq_factor", 1.0),
    ("high_freq_factor", 4.0),
    ("original_context_length", 8192),
)


@dataclass(frozen=True)
class VisionEncoderConfig:
    """Plain-ViT vision tower config."""

    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    num_channels: int = 3
    image_size: int = 560
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    attention_dropout: float = 0.0
    num_image_tokens: Optional[int] = None
    projection_dim: Optional[int] = None  # injected by MLLAMAConfig

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class LLAMA32Config:
    """LLaMA-3.2 text decoder config."""

    vocab_size: int
    hidden_size: int = 4096
    context_length: int = 131072
    n_heads: int = 32
    n_layers: int = 16
    hidden_dim: int = 8192
    max_position_embeddings: int = 2048
    n_kv_groups: int = 8
    rope_base: float = 500000.0
    rms_norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    rope_freq: Tuple[Tuple[str, float], ...] = DEFAULT_ROPE_FREQ
    pad_token_index: Optional[int] = None
    num_image_tokens: Optional[int] = None
    apply_rope_scaling: bool = False
    max_cache_length: int = 2048

    def __post_init__(self):
        if isinstance(self.rope_freq, Mapping):
            object.__setattr__(self, "rope_freq", tuple(sorted(self.rope_freq.items())))
        if self.hidden_size % self.n_heads != 0:
            raise ValueError("hidden_size must be a multiple of n_heads")
        if self.n_heads % self.n_kv_groups != 0:
            raise ValueError("n_heads must be a multiple of n_kv_groups")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_heads

    @property
    def group_size(self) -> int:
        return self.n_heads // self.n_kv_groups

    @property
    def rope_freq_dict(self) -> dict:
        return dict(self.rope_freq)

    @property
    def torch_dtype(self) -> torch.dtype:
        return resolve_dtype(self.dtype)


@dataclass(frozen=True)
class MLLAMAConfig:
    """VLM config composing vision + text. Derives
    ``text_config.num_image_tokens`` and injects ``projection_dim`` into the
    vision config, as the JAX package does."""

    vision_config: Any = None
    text_config: Any = None
    ignore_index: int = -100
    image_token_index: int = 128256
    vocab_size: int = 128256
    projection_dim: int = 4096
    hidden_size: int = 4096
    pad_token_index: Optional[int] = None
    is_encoder_decoder: bool = False

    def __post_init__(self):
        vc = self.vision_config
        if isinstance(vc, Mapping):
            vc = VisionEncoderConfig(**vc)
        elif vc is None:
            vc = VisionEncoderConfig()

        tc = self.text_config
        if isinstance(tc, Mapping):
            tc = LLAMA32Config(**{**tc, "pad_token_index": self.pad_token_index})
        if tc is None:
            raise ValueError("text_config is required")

        num_image_tokens = (vc.image_size // vc.patch_size) ** 2
        tc = dataclasses.replace(tc, num_image_tokens=num_image_tokens)
        vc = dataclasses.replace(vc, projection_dim=self.projection_dim)

        object.__setattr__(self, "vision_config", vc)
        object.__setattr__(self, "text_config", tc)
        object.__setattr__(self, "vocab_size", tc.vocab_size)


def tiny_mllama_config(
    vocab_size: int = 256,
    dtype: str = "float32",
    image_token_index: int = 250,
    max_cache_length: int = 128,
) -> MLLAMAConfig:
    """Tiny random-init VLM config: 2-layer ViT + 2-layer text, fp32."""
    return MLLAMAConfig(
        vision_config=VisionEncoderConfig(
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            image_size=28,
            patch_size=14,
        ),
        text_config=LLAMA32Config(
            vocab_size=vocab_size,
            hidden_size=64,
            context_length=2048,
            n_heads=4,
            n_layers=2,
            hidden_dim=128,
            n_kv_groups=2,
            dtype=dtype,
            max_cache_length=max_cache_length,
        ),
        image_token_index=image_token_index,
        vocab_size=vocab_size,
        projection_dim=64,
        hidden_size=64,
    )


def llama32_11b_vision_config(dtype: str = "bfloat16", **overrides) -> MLLAMAConfig:
    """Llama-3.2-11B-Vision-Instruct shapes (ViT-H/14 @ 560px vision tower)."""
    return MLLAMAConfig(
        vision_config=VisionEncoderConfig(),
        text_config=LLAMA32Config(
            vocab_size=128256,
            hidden_size=4096,
            n_heads=32,
            n_layers=40,
            hidden_dim=14336,
            n_kv_groups=8,
            dtype=dtype,
            **overrides,
        ),
        projection_dim=4096,
        hidden_size=4096,
    )


def llama32_90b_vision_config(dtype: str = "bfloat16", **overrides) -> MLLAMAConfig:
    """Llama-3.2-90B-Vision-Instruct shapes."""
    return MLLAMAConfig(
        vision_config=VisionEncoderConfig(),
        text_config=LLAMA32Config(
            vocab_size=128256,
            hidden_size=8192,
            n_heads=64,
            n_layers=80,
            hidden_dim=28672,
            n_kv_groups=8,
            dtype=dtype,
            **overrides,
        ),
        projection_dim=8192,
        hidden_size=8192,
    )
