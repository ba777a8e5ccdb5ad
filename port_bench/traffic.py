"""The one generator of every traffic mix: it reads a mix's parameters
(``port_bench/traffic/<mix>.json``) and makes its inputs on the device from a seed.
The same seed gives the same inputs; every seed gives the same shapes.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F


def train_pool(mix: dict, vocab: int, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``mix["pool"]`` training batches on the device, each of ``mix["clips"]`` clips:

    - ``images`` ``[clips, frames, S, S, 3]`` uint8 NHWC. Each clip blends two smooth
      random images A -> B over time, its frames in the order the data pipeline emits them
      (start, goal, then ordered middle frames), so the time-contrastive and language
      losses have structure to find;
    - ``token_ids`` and ``attn_mask`` ``[clips, tokens]``: captions of ``min_tokens`` to
      ``tokens`` ids, padded with id 0 to ``tokens``;
    - ``lang_mask`` ``[clips]``: 0 for the first ``empty_captions`` clips (no caption).
    """
    gen = torch.Generator(device=device).manual_seed(seed)
    return [_train_batch(gen, mix, vocab, device) for _ in range(mix["pool"])]


def _train_batch(gen, mix: dict, vocab: int, device) -> Dict[str, torch.Tensor]:
    clips, frames, hw, tokens = mix["clips"], mix["frames"], mix["frame_size"], mix["tokens"]
    ends = torch.rand((2 * clips, 3, 28, 28), generator=gen, device=device) * 255.0
    ends = F.interpolate(ends, size=(hw, hw), mode="bilinear", align_corners=False)
    a, b = ends.permute(0, 2, 3, 1).reshape(2, clips, 1, hw, hw, 3)
    middle = torch.rand((clips, frames - 2), generator=gen, device=device).sort(dim=1).values
    t = torch.cat([torch.zeros((clips, 1), device=device),
                   torch.ones((clips, 1), device=device), middle], dim=1)[:, :, None, None, None]
    images = ((1.0 - t) * a + t * b).round().to(torch.uint8)
    lengths = torch.randint(mix["min_tokens"], tokens + 1, (clips,), generator=gen,
                            device=device)
    attn_mask = (torch.arange(tokens, device=device)[None] < lengths[:, None]).long()
    token_ids = torch.randint(1, vocab, (clips, tokens), generator=gen, device=device)
    lang_mask = torch.ones(clips, device=device)
    lang_mask[:mix["empty_captions"]] = 0.0
    return {"images": images, "token_ids": token_ids * attn_mask, "attn_mask": attn_mask,
            "lang_mask": lang_mask}


def frame_pool(mix: dict, seed: int, device) -> torch.Tensor:
    """``[pool, frames, 3, S, S]`` uint8 NCHW requests made on the device: smooth random
    images with fine noise on top, as camera frames have."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n, hw = mix["pool"] * mix["frames"], mix["frame_size"]
    smooth = torch.rand((n, 3, 14, 14), generator=gen, device=device) * 255.0
    smooth = F.interpolate(smooth, size=(hw, hw), mode="bilinear", align_corners=False)
    noise = torch.randn((n, 3, hw, hw), generator=gen, device=device) * 8.0
    images = (smooth + noise).clamp(0.0, 255.0).round().to(torch.uint8)
    return images.reshape(mix["pool"], mix["frames"], 3, hw, hw)


def request_order(mix: dict, seed: int) -> List[int]:
    """The pool entries in the order the client sends them (cycled)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(mix["pool"], generator=gen).tolist()
