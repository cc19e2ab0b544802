"""Image preprocessing (counterpart of ``llama32mm_tpu/preprocess/image.py``).

Host pipeline (the reference's ``process_images``): PIL bicubic resize to
``(size, size)`` → fp32 ×1/255 → per-channel (x - mean)/std → HWC→CHW, in
numpy. The constants are named ``IMAGENET_STANDARD_*`` as in the reference
but are CLIP's mean/std.

On the device, ``preprocess_image_device`` does the same from uint8
``[B, H, W, C]``, resizing with ``cubic_resize`` when the image is not
``image_size`` square: the raw pixels are the only host-to-device copy.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

IMAGENET_STANDARD_MEAN = [0.48145466, 0.4578275, 0.40821073]
IMAGENET_STANDARD_STD = [0.26862954, 0.26130258, 0.27577711]


def resize(image, size: Tuple[int, int], resample=None, reducing_gap=None):
    """PIL resize; ``size`` is (height, width) like the reference."""
    height, width = size
    return image.resize((width, height), resample=resample, reducing_gap=reducing_gap)


def rescale(image: np.ndarray, scale: float, dtype=np.float32) -> np.ndarray:
    return (image * scale).astype(dtype)


def normalize(image: np.ndarray, mean, std) -> np.ndarray:
    mean = np.array(mean, dtype=image.dtype)
    std = np.array(std, dtype=image.dtype)
    return (image - mean) / std


def process_images(
    images: Sequence,
    size: Optional[Tuple[int, int]] = None,
    resample=None,
    rescale_factor: Optional[float] = None,
    image_mean=None,
    image_std=None,
) -> List[np.ndarray]:
    """Host-side pipeline (reference ``process_images``): returns a list of
    CHW fp32 arrays."""
    height, width = size[0], size[1]
    images = [resize(im, (height, width), resample=resample) for im in images]
    images = [np.array(im) for im in images]
    images = [rescale(im, scale=rescale_factor) for im in images]
    images = [normalize(im, mean=image_mean, std=image_std) for im in images]
    return [im.transpose(2, 0, 1) for im in images]


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel, a = -0.5, at ``|x|``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``[n_out, n_in]`` fp32 weights of one axis of
    ``jax.image.resize(method="cubic")`` (``scale_and_translate``'s
    ``compute_weight_mat``, antialiased: a downscale widens the kernel by
    the scale), each output row normalised by its sum."""
    f32 = dict(dtype=torch.float32, device=device)
    inv_scale = 1.0 / (n_out / n_in)
    # 0-dim fp32 host tensors: JAX's fp32 scalars, and no host-to-device copy
    sample = (torch.arange(n_out, **f32) + 0.5) * torch.tensor(inv_scale, dtype=torch.float32) - 0.5
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=torch.float32)
    x = (sample[None, :] - torch.arange(n_in, **f32)[:, None]).abs() / kernel_scale
    w = _keys_cubic(x)  # [n_in, n_out]
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).t().contiguous()


def cubic_resize(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, height, width, C), method="cubic")`` for a
    float32 ``[B, H, W, C]`` tensor, on its device: per resized axis, one
    GEMM with that axis' weight matrix (height first; the width's on the
    rows ``[B·height·C, W]``, so the weights are read once). The products
    run in fp32 (nothing here enables TF32). Values are not clamped: a
    cubic overshoots past [0, 255] near edges, as in JAX."""
    b, h, w, c = x.shape
    if h != height:
        x = torch.matmul(_resize_weights(h, height, x.device), x.reshape(b, h, w * c))
        x = x.reshape(b, height, w, c)
    if w != width:
        rows = x.permute(0, 1, 3, 2).reshape(b * height * c, w)
        x = torch.matmul(rows, _resize_weights(w, width, x.device).t())
        x = x.reshape(b, height, c, width).permute(0, 1, 3, 2)
    return x


def preprocess_image_device(raw_uint8: torch.Tensor, image_size: int,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 ``[B, H, W, C]`` → ``[B, C, image_size, image_size]`` in
    ``dtype`` on the tensor's device: resized (``cubic_resize``) when the
    input is not ``image_size`` square, ×1/255, CLIP mean/std."""
    if raw_uint8.dim() != 4:
        raise ValueError(f"expected [B, H, W, C] pixels, got {tuple(raw_uint8.shape)}")
    x = raw_uint8.float()
    if x.shape[1] != image_size or x.shape[2] != image_size:
        x = cubic_resize(x, image_size, image_size)
    x = x * (1.0 / 255.0)
    mean = torch.tensor(IMAGENET_STANDARD_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STANDARD_STD, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    return x.permute(0, 3, 1, 2).to(dtype)

