"""On-device image preprocessing (counterpart of
``llama32mm_tpu/preprocess/image.py::preprocess_image_device``).

uint8 ``[B, H, W, C]`` → ×1/255 → CLIP mean/std → ``[B, C, H, W]``, on the
tensor's device; the raw pixels are the only host-to-device copy. Resizing
is not ported: ``jax.image.resize(method="cubic")`` is Keys a=-0.5 with
antialiasing and torch's bicubic is a=-0.75, so the two would differ.
"""

from __future__ import annotations

import torch

# CLIP's constants, under the reference's ImageNet names
IMAGENET_STANDARD_MEAN = [0.48145466, 0.4578275, 0.40821073]
IMAGENET_STANDARD_STD = [0.26862954, 0.26130258, 0.27577711]


def preprocess_image_device(raw_uint8: torch.Tensor, image_size: int,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Returns ``[B, C, image_size, image_size]`` in ``dtype``."""
    if raw_uint8.dim() != 4 or raw_uint8.shape[1] != image_size or raw_uint8.shape[2] != image_size:
        raise ValueError(
            f"expected [B, {image_size}, {image_size}, C] pixels, got {tuple(raw_uint8.shape)}; "
            "resizing is not ported yet (ROADMAP.md, queue 1 item 6)"
        )
    x = raw_uint8.float() * (1.0 / 255.0)
    mean = torch.tensor(IMAGENET_STANDARD_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STANDARD_STD, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    return x.permute(0, 3, 1, 2).to(dtype)
