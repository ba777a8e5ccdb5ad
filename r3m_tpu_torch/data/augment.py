"""On-device RandomResizedCrop augmentation (rc and rctraj), the port of
``r3m_tpu/data/augment.py``.

The reference augments on the host with torchvision's ``RandomResizedCrop(224,
scale=(0.2, 1.0))`` (``data_loaders.py:47-52,81-102``). Here both halves run on the
device, split so that tests can hand both packages the same rectangles:

* `sample_crop_params` is torchvision's crop-parameter law (10 rejection-sampling
  attempts over area scale U(0.2, 1.0) and log-uniform aspect ratio 3/4..4/3, then a
  ratio-clamped centre-crop fallback), vectorised over crops and drawn from a
  `torch.Generator`;
* `resized_crop` crops and bilinearly resizes with crop-clamped tent weights, two plain
  matrix products per frame, with the 0-255 -> 0-1 rescale folded into the row weights and
  the mean/std normalisation after, in the compute dtype.

Modes: ``rctraj`` draws one crop per clip for all its frames, ``rc`` one per frame, and
``none`` passes pre-sized frames through.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

ATTEMPTS = 10  # torchvision RandomResizedCrop.get_params
SCALE = (0.2, 1.0)  # area share of the crop, as data_loaders.py:47-52 sets it
LOG_RATIO = (math.log(3.0 / 4.0), math.log(4.0 / 3.0))


def _check_norm_pair(mean, std) -> None:
    if (mean is None) != (std is None):
        raise ValueError("mean and std must be given together (got only one)")


def sample_crop_params(
    generator: torch.Generator,
    n: int,
    height: int,
    width: int,
) -> torch.Tensor:
    """``n`` crop rectangles ``[n, 4]`` (i, j, h, w) in f32 by torchvision's law.

    All 10 attempts are drawn at once and the first valid one is taken, else the
    centre-crop fallback with the aspect ratio clamped. Draws from `generator` on its
    device: area scales, then log aspect ratios, then the two offsets.
    """
    device = generator.device
    area = float(height * width)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo

    target_area = area * uniform((n, ATTEMPTS), *SCALE)
    aspect = torch.exp(uniform((n, ATTEMPTS), *LOG_RATIO))
    w = torch.round(torch.sqrt(target_area * aspect))
    h = torch.round(torch.sqrt(target_area / aspect))
    valid = (w > 0) & (w <= width) & (h > 0) & (h <= height)
    first = torch.argmax(valid.to(torch.float32), dim=1, keepdim=True)  # first True
    any_valid = valid.any(dim=1)
    h_sel = h.gather(1, first)[:, 0]
    w_sel = w.gather(1, first)[:, 0]
    u = torch.rand((n, 2), generator=generator, device=device)
    i_sel = torch.floor(u[:, 0] * (height - h_sel + 1))
    j_sel = torch.floor(u[:, 1] * (width - w_sel + 1))

    in_ratio = width / height
    min_r, max_r = math.exp(LOG_RATIO[0]), math.exp(LOG_RATIO[1])
    if in_ratio < min_r:
        fw, fh = float(width), float(round(width / min_r))
    elif in_ratio > max_r:
        fh, fw = float(height), float(round(height * max_r))
    else:
        fw, fh = float(width), float(height)
    fallback = torch.tensor(
        [(height - fh) // 2, (width - fw) // 2, fh, fw], dtype=torch.float32, device=device
    )
    chosen = torch.stack([i_sel, j_sel, h_sel, w_sel], dim=1)
    return torch.where(any_valid[:, None], chosen, fallback)


def _tent(size_out: int, size_in: int, start: torch.Tensor, extent: torch.Tensor):
    """``[n, out, in]`` bilinear weights: output pixel o samples the crop at
    (o + 0.5) * extent/out - 0.5, clamped inside the crop, then shifted by `start`."""
    o = torch.arange(size_out, dtype=torch.float32, device=start.device) + 0.5
    pos = o[None] * (extent[:, None] / size_out) - 0.5
    pos = torch.minimum(torch.clamp(pos, min=0.0), (extent - 1.0)[:, None]) + start[:, None]
    grid = torch.arange(size_in, dtype=torch.float32, device=start.device)
    return torch.clamp(1.0 - (grid[None, None, :] - pos[:, :, None]).abs(), min=0.0)


def resized_crop(
    images: torch.Tensor,
    rects: torch.Tensor,
    out_size: int,
    compute_dtype: torch.dtype = torch.float32,
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """Crop ``images[k]`` (NHWC ``[n, H, W, C]``) to ``rects[k]`` (i, j, h, w) and resize
    each crop bilinearly to ``[out_size, out_size]``.

    Half-pixel sampling (align_corners=False, no antialias) with coordinates clamped to
    the crop, since torch crops before it interpolates. The two tent-weight products run
    in `compute_dtype`. With `mean`/`std` the /255 rescale is folded into the row weights
    and the output is ``(x/255 - mean) / std`` in `compute_dtype`.
    """
    _check_norm_pair(mean, std)
    n, hi, wi, c = images.shape
    rects = rects.to(device=images.device, dtype=torch.float32)
    wy = _tent(out_size, hi, rects[:, 0], rects[:, 2])  # [n, out, H]
    wx = _tent(out_size, wi, rects[:, 1], rects[:, 3])  # [n, out, W]
    if mean is not None:
        wy = wy * (1.0 / 255.0)
    img = images.to(compute_dtype)
    rows = torch.bmm(wy.to(compute_dtype), img.reshape(n, hi, wi * c))  # [n, out, W*C]
    rows = rows.reshape(n, out_size, wi, c).transpose(1, 2).reshape(n, wi, out_size * c)
    out = torch.bmm(wx.to(compute_dtype), rows)  # [n, out(x), out(y)*C]
    out = out.reshape(n, out_size, out_size, c).transpose(1, 2)  # [n, y, x, C]
    if mean is not None:
        m = torch.tensor(mean, dtype=compute_dtype, device=images.device)
        inv = torch.tensor([1.0 / s for s in std], dtype=compute_dtype, device=images.device)
        out = (out - m) * inv
    return out.contiguous()


def random_resized_crop_clips(
    clips: torch.Tensor,
    out_size: int = 224,
    mode: str = "rctraj",
    generator: Optional[torch.Generator] = None,
    rects: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """Augment ``[B, F, H, W, C]`` clips -> ``[B, F, out, out, C]``.

    ``rctraj``: one crop per clip shared by its F frames; ``rc``: one crop per frame;
    ``none``: frames pass through (they must be ``out_size`` square already). The crops
    come from `rects` when given (``[B, 4]`` for rctraj, ``[B, F, 4]`` for rc), else they
    are drawn from `generator` with `sample_crop_params`. Output as `resized_crop`'s.
    """
    _check_norm_pair(mean, std)
    b, f, hgt, wid, c = clips.shape
    if mode not in ("rc", "rctraj", "none"):
        raise ValueError(f"mode must be 'rc'|'rctraj'|'none', got {mode!r}")
    if mode == "none":
        if hgt != out_size or wid != out_size:
            raise ValueError("mode='none' needs pre-sized frames")
        x = clips.to(compute_dtype)
        if mean is not None:
            m = torch.tensor(mean, dtype=compute_dtype, device=clips.device)
            inv = torch.tensor([1.0 / (255.0 * s) for s in std], dtype=compute_dtype,
                               device=clips.device)
            x = (x - 255.0 * m) * inv
        return x
    n_rects = b if mode == "rctraj" else b * f
    if rects is None:
        if generator is None:
            raise ValueError("random_resized_crop_clips needs a generator or rects")
        rects = sample_crop_params(generator, n_rects, hgt, wid)
    rects = rects.reshape(n_rects, 4)
    if mode == "rctraj":
        rects = rects.repeat_interleave(f, dim=0)
    out = resized_crop(clips.reshape(b * f, hgt, wid, c), rects, out_size,
                       compute_dtype, mean, std)
    return out.reshape(b, f, out_size, out_size, c)
