"""R3M's pretraining step and its serving forward, in plain PyTorch.

The step follows the published R3M trainer (Nair et al. 2022, ``r3m/trainer.py``): a
batch of 5-frame clips (start, goal, three ordered middle frames) is cropped with
torchvision's RandomResizedCrop law, one rectangle a clip, normalised and encoded; the
loss is the L1 and L2 penalties on the embeddings, the time-contrastive InfoNCE over
-L2 similarities with three cross-clip negatives, and the language InfoNCE of the reward
head over the frozen DistilBERT caption embedding (empty captions masked, the mean over
the full batch); Adam updates the encoder and the head, and BatchNorm's running
statistics move with the batch. The random crops and negative permutations are a frozen
copy of the draws the system makes from the same generator state (`draw_crops`,
`draw_perms`), so both sides crop and contrast the same frames.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from port_bench.reference import nets
from port_bench.reference.precision import Arith

EPS = 1e-8
ATTEMPTS = 10
SCALE = (0.2, 1.0)
LOG_RATIO = (math.log(3.0 / 4.0), math.log(4.0 / 3.0))
ADAM = dict(beta1=0.9, beta2=0.999, eps=1e-8)
FRAMES = 5


# --- the draws ---------------------------------------------------------------------------

def draw_crops(gen: torch.Generator, n: int, height: int, width: int) -> torch.Tensor:
    """``[n, 4]`` (i, j, h, w): torchvision's RandomResizedCrop law, all ten attempts drawn
    at once, in the order and arithmetic of the system's draw from `gen`."""
    device = gen.device
    area = float(height * width)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    target = area * uniform((n, ATTEMPTS), *SCALE)
    aspect = torch.exp(uniform((n, ATTEMPTS), *LOG_RATIO))
    w = torch.round(torch.sqrt(target * aspect))
    h = torch.round(torch.sqrt(target / aspect))
    valid = (w > 0) & (w <= width) & (h > 0) & (h <= height)
    first = torch.argmax(valid.to(torch.float32), dim=1, keepdim=True)
    h_sel, w_sel = h.gather(1, first)[:, 0], w.gather(1, first)[:, 0]
    u = torch.rand((n, 2), generator=gen, device=device)
    i_sel = torch.floor(u[:, 0] * (height - h_sel + 1))
    j_sel = torch.floor(u[:, 1] * (width - w_sel + 1))
    ratio = width / height
    lo, hi = math.exp(LOG_RATIO[0]), math.exp(LOG_RATIO[1])
    if ratio < lo:
        fw, fh = float(width), float(round(width / lo))
    elif ratio > hi:
        fh, fw = float(height), float(round(height * hi))
    else:
        fw, fh = float(width), float(height)
    fallback = torch.tensor([(height - fh) // 2, (width - fw) // 2, fh, fw],
                            dtype=torch.float32, device=device)
    chosen = torch.stack([i_sel, j_sel, h_sel, w_sel], dim=1)
    return torch.where(valid.any(dim=1)[:, None], chosen, fallback)


def draw_perms(gen: torch.Generator, bs: int, num_neg: int) -> Dict[str, torch.Tensor]:
    """The negatives of one step: ``lang [num_neg, 3, bs]`` then ``tcn [num_neg, 2, bs]``,
    one `randperm` each."""
    def perms(n):
        return torch.stack([torch.randperm(bs, generator=gen, device=gen.device)
                            for _ in range(n)])

    return {"lang": perms(num_neg * 3).reshape(num_neg, 3, bs),
            "tcn": perms(num_neg * 2).reshape(num_neg, 2, bs)}


# --- preprocessing ----------------------------------------------------------------------

def crop_normalize(clips: torch.Tensor, rects: torch.Tensor, size: int, mean, std
                   ) -> torch.Tensor:
    """``[B, F, H, W, 3]`` uint8 clips and ``[B, 4]`` rectangles -> ``[B*F, 3, size,
    size]`` f32: each clip's rectangle cut from all its frames, resized bilinearly (half
    pixel, no antialias, the crop's own border), scaled to [0, 1] and normalised."""
    out = []
    for clip, (i, j, h, w) in zip(clips, rects.to(torch.int64).tolist()):
        x = clip.permute(0, 3, 1, 2).to(torch.float32)[:, :, i:i + h, j:j + w]
        out.append(F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False))
    return normalize(torch.cat(out) / 255.0, mean, std)


def normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    m = torch.tensor(mean, dtype=x.dtype, device=x.device)[:, None, None]
    s = torch.tensor(std, dtype=x.dtype, device=x.device)[:, None, None]
    return (x - m) / s


def encode(cfg: dict, p: Dict[str, torch.Tensor], x: torch.Tensor, train: bool,
           arith: Arith) -> torch.Tensor:
    """Normalised NCHW frames -> embeddings, by the configuration's backbone."""
    if cfg["backbone"]["kind"] == "vit":
        return nets.vit_forward(p, x, cfg["backbone"], arith)
    return nets.resnet_forward(p, x, cfg["backbone"], train, arith)


def serve(cfg: dict, p: Dict[str, torch.Tensor], frames: torch.Tensor, arith: Arith
          ) -> torch.Tensor:
    """``[N, 3, S, S]`` uint8 frames at the crop size -> ``[N, D]`` embeddings: /255,
    normalised, the backbone in eval mode."""
    with torch.no_grad(), arith.scope():
        mean, std = cfg["backbone"]["norm_mean"], cfg["backbone"]["norm_std"]
        return encode(cfg, p, normalize(frames.to(torch.float32) / 255.0, mean, std),
                      False, arith)


# --- the loss ----------------------------------------------------------------------------

def _info_nce(pos, negs: List[torch.Tensor]) -> torch.Tensor:
    denom = EPS + torch.exp(pos) + sum(torch.exp(n) for n in negs)
    return -torch.log(EPS + torch.exp(pos) / denom)


def _sim(a, b):
    return -torch.linalg.vector_norm(a - b, dim=-1)


def r3m_loss(model: dict, emb: torch.Tensor, lang: Optional[torch.Tensor],
             lang_mask: Optional[torch.Tensor], perms, rew: Dict[str, torch.Tensor],
             arith: Arith) -> torch.Tensor:
    """The full loss over ``[B, 5, D]`` embeddings in the order (e0, eg, es0, es1, es2)."""
    e0, eg, es0, es1, es2 = emb.unbind(1)
    flat = emb.reshape(-1, emb.shape[-1])
    loss = (model["l2weight"] * torch.linalg.vector_norm(flat, dim=-1).mean()
            + model["l1weight"] * flat.abs().sum(dim=-1).mean())
    if model["langweight"] > 0:
        def score(a, b):
            return nets.reward_forward(rew, a, b, lang, arith)

        terms = 0.0
        for t, (second, within) in enumerate(((eg, e0), (es1, es0), (es2, es1))):
            negs = [score(e0, within)]
            negs += [score(e0[p], second[p]) for p in perms["lang"][:, t]]
            terms = terms + _info_nce(score(e0, second), negs)
        loss = loss + model["langweight"] * (terms / 3.0 * lang_mask).mean()
    if model["tcnweight"] > 0:
        s02, s12, s01 = _sim(es2, es0), _sim(es2, es1), _sim(es1, es0)
        neg0 = [_sim(es0, es0[p]) for p in perms["tcn"][:, 0]]
        neg2 = [_sim(es2, es2[p]) for p in perms["tcn"][:, 1]]
        r1 = torch.exp(s12) / (EPS + torch.exp(s02) + torch.exp(s12)
                               + sum(torch.exp(n) for n in neg2))
        r2 = torch.exp(s01) / (EPS + torch.exp(s01) + torch.exp(s02)
                               + sum(torch.exp(n) for n in neg0))
        tcn = ((-torch.log(EPS + r1) - torch.log(EPS + r2)) / 2.0).mean()
        loss = loss + model["tcnweight"] * tcn
    return loss


# --- the step ----------------------------------------------------------------------------

class TrainRef:
    """The trainable tensors (``convnet.*``, ``lang_rew.*``), the BatchNorm statistics,
    Adam's moments and the step count; `step` runs one update in place."""

    def __init__(self, cfg: dict, state: Dict[str, torch.Tensor],
                 bert: Dict[str, torch.Tensor], arith: Arith):
        self.cfg, self.bert, self.arith = cfg, bert, arith
        self.params = {k: v.clone().requires_grad_(True) for k, v in state.items()
                       if v.is_floating_point() and not k.endswith(("running_mean",
                                                                      "running_var"))}
        self.buffers = {k: v.clone() for k, v in state.items() if k not in self.params}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {**self.params, **self.buffers}

    def _part(self, prefix: str) -> Dict[str, torch.Tensor]:
        return {k[len(prefix):]: v for k, v in self.tensors().items() if k.startswith(prefix)}

    def step(self, batch: Dict[str, torch.Tensor], crops: torch.Tensor, perms,
             drop_half: bool = False):
        """One update on `batch`; returns (loss, gradients). `drop_half` is a planted
        fault: the second half of the clips is left out and the loss is their mean."""
        cfg, model, arith = self.cfg, self.cfg["model"], self.arith
        images = batch["images"]
        if drop_half:
            keep = images.shape[0] // 2
            batch = {k: v[:keep] for k, v in batch.items()}
            images, crops = batch["images"], crops[:keep]
            perms = {k: torch.stack([r[r < keep] for r in v.reshape(-1, v.shape[-1])])
                     .reshape(*v.shape[:-1], keep) for k, v in perms.items()}
        bs = images.shape[0]
        with arith.scope():
            lang = mask = None
            if model["langweight"] > 0:
                with torch.no_grad():
                    lang = nets.bert_sentence(self.bert, batch["token_ids"],
                                              batch["attn_mask"], cfg["language_model"],
                                              arith)
                mask = batch["lang_mask"].to(torch.float32)
            bb = cfg["backbone"]
            x = crop_normalize(images, crops, model["image_size"], bb["norm_mean"],
                               bb["norm_std"])
            emb = encode(cfg, self._part("convnet."), x, True, arith)
            loss = r3m_loss(model, emb.reshape(bs, FRAMES, -1), lang, mask, perms,
                            self._part("lang_rew."), arith)
            names = list(self.params)
            grads = dict(zip(names, torch.autograd.grad(loss, [self.params[k] for k in names])))
        self._adam(grads, model["lr"])
        return loss.detach(), grads

    @torch.no_grad()
    def _adam(self, grads, lr: float) -> None:
        b1, b2, eps = ADAM["beta1"], ADAM["beta2"], ADAM["eps"]
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            p -= lr / c1 * self.m[k] / (torch.sqrt(self.v[k]) / math.sqrt(c2) + eps)
