"""Image preprocessing on the device (NHWC), the port of ``r3m_tpu/ops/image.py``.

The reference's torchvision serving transform: /255, then Resize(256) + CenterCrop(224)
when the input is not already the crop size, then Normalize. Functions take NHWC float
input in [0, 255] unless noted, as the JAX functions do.

Resize is ``F.interpolate(mode="bilinear", align_corners=False)`` with no antialiasing:
torch 1.7.1's tensor-mode ``transforms.Resize``, and the law ``jax.image.resize(...,
antialias=False)`` implements. The two agree to float rounding, borders included
(tests/test_torch_ops.py holds them together on a non-square input).
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F

# ImageNet statistics (models_r3m.py:61); ViT uses 0.5/0.5 (models_r3m.py:59).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VIT_MEAN = (0.5, 0.5, 0.5)
VIT_STD = (0.5, 0.5, 0.5)


@functools.lru_cache(maxsize=None)
def _channel_stats(mean: tuple, std: tuple, device: torch.device, dtype: torch.dtype):
    """``(mean, 1 / std)`` as tensors on `device`, made once a (statistics, device, dtype):
    each is a copy from the host's pageable memory, which a CUDA graph's capture does not
    admit. Never inference tensors, so that autograd may save them."""
    with torch.inference_mode(False):
        mean_t = torch.tensor(mean, dtype=dtype, device=device)
        inv_std = 1.0 / torch.tensor(std, dtype=dtype, device=device)
    return mean_t, inv_std


def normalize(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Channel-wise (x - mean) / std over the last (C) axis; x in [0, 1]."""
    mean_t, inv_std = _channel_stats(tuple(mean), tuple(std), x.device, x.dtype)
    return (x - mean_t) * inv_std


def resize_shorter_side(x: torch.Tensor, target: int = 256) -> torch.Tensor:
    """torchvision Resize(int) over NHWC: scale so the shorter side == target.

    Bilinear, no antialias. The long edge TRUNCATES, as torchvision's
    ``int(size * w / h)`` does: 427x640 -> 256x383, not 384.
    """
    _, h, w, _ = x.shape
    if h <= w:
        nh, nw = target, max(1, int(w * target / h))
    else:
        nh, nw = max(1, int(h * target / w)), target
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear", align_corners=False
    )
    return y.permute(0, 2, 3, 1)


def center_crop(x: torch.Tensor, size: int = 224) -> torch.Tensor:
    """torchvision CenterCrop(size) over NHWC; pads with zeros if the image is smaller."""
    _, h, w, _ = x.shape
    if h < size or w < size:
        ph, pw = max(size - h, 0), max(size - w, 0)
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        _, h, w, _ = x.shape
    top = (h - size) // 2
    left = (w - size) // 2
    return x[:, top : top + size, left : left + size, :]


def r3m_preprocess(
    obs: torch.Tensor,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    crop_size: int = 224,
    resize_to: int = 256,
) -> torch.Tensor:
    """Full reference preprocessing (models_r3m.py:84-98) over NHWC in [0, 255].

    If the spatial dims differ from `crop_size`, Resize(resize_to) + CenterCrop(crop_size)
    come first; then the image is scaled to [0, 1] and normalized. Returns float32.
    """
    x = obs.to(torch.float32) / 255.0
    if obs.shape[1] != crop_size or obs.shape[2] != crop_size:
        x = resize_shorter_side(x, resize_to)
        x = center_crop(x, crop_size)
    return normalize(x, mean, std)
