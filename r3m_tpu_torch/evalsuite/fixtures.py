"""Probe fixture: a synthetic manipulation world with recoverable latents, the port's copy
of ``r3m_tpu/evalsuite/fixtures.py``.

R3M exists to give a *reusable* visual representation, evaluated downstream (the
reference's behaviour-cloning evaluation; paper §4). This module is the in-repo testbed
for that claim on a host with no network: a rendered "reach" world whose ground-truth
latent factors are known, so representation quality is measurable as probe error.

World (per video): a red block starts at a random position and moves in a straight line
toward a green goal disk at a random fixed position, over a random low-frequency
background texture (the video's identity). Every frame therefore encodes — and a good
representation must expose —

  * the block position  (changes over time  -> what TCN contrast rewards),
  * the goal position   (static per video   -> what cross-video negatives and the
                         language loss reward),
  * task progress       (block->goal distance, the time axis itself).

The BC action label is the classic reach policy: the unit vector from block to goal
(recoverable from a SINGLE frame, since both are rendered). Captions narrate the motion
direction 8-way ("C person moves the block to the upper left"), giving the
language-reward loss a real alignment target.

`write_probe_dataset` emits the Ego4D training layout (``manifest.csv`` and 1-based JPEG
frames, data_loaders.py:30-34,68-74), which `r3m_tpu_torch.data.ego4d` reads;
`render_probe_set` returns an in-memory held-out probe set (frames + actions + latents).
Everything here is host numpy in the JAX package's arithmetic: the same seeds give the
same arrays, JPEG bytes and manifest rows.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

_DIRS = (
    ((1, 0), "right"),
    ((1, 1), "lower right"),
    ((0, 1), "bottom"),
    ((-1, 1), "lower left"),
    ((-1, 0), "left"),
    ((-1, -1), "upper left"),
    ((0, -1), "top"),
    ((1, -1), "upper right"),
)

# every word the captions use (WordPiece vocab companion)
PROBE_VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]",
    "person", "moves", "the", "block", "to",
    "right", "left", "top", "bottom", "upper", "lower",
]


def _dir_index(delta: np.ndarray) -> int:
    """8-way compass sector of the motion vector (y axis points DOWN)."""
    ang = np.arctan2(delta[1], delta[0])
    return int(np.round(ang / (np.pi / 4))) % 8


def _direction_phrase(delta: np.ndarray) -> str:
    return _DIRS[_dir_index(delta)][1]


def probe_captions() -> list:
    """The 8 direction captions exactly as training sees them (the manifest's txt with
    the leading "C " stripped, data_loaders.py:72)."""
    return [f"person moves the block to the {name}" for _, name in _DIRS]


def _host(x) -> np.ndarray:
    """`x` as a host array: a numpy array, or a tensor on any device."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def caption_contrast_acc(score_fn, e_first, e_last, deltas) -> float:
    """Zero-shot language-reward discrimination on held-out videos.

    For each video, score the (first-frame, last-frame) embedding pair against ALL 8
    direction captions with the model's own trained reward head (`get_reward`,
    models_r3m.py:78-81 — the quantity the reference deploys as an RL reward, paper §4.3)
    and ask whether the TRUE caption wins the 8-way argmax. No probe head is fitted;
    chance is 1/8. This is the direct evidence that the LANGUAGE loss trained a
    caption-discriminating reward, complementing `reward_order_acc` (which only tests
    temporal monotonicity).

    `score_fn(e0 [N,D], es [N,D], captions: list[N]) -> [N] scores` (an array, or a
    tensor on any device, as `R3MRewardModel.get_reward` returns); `e_first`/`e_last`:
    [V, D] per-video first/last frame embeddings (arrays or tensors); `deltas`: [V, 2]
    goal - start motion vectors (any scale, y down).
    """
    caps = probe_captions()
    e_first = _host(e_first)
    e_last = _host(e_last)
    v, k = e_first.shape[0], len(caps)
    e0 = np.repeat(e_first, k, axis=0)
    et = np.repeat(e_last, k, axis=0)
    sentences = [c for _ in range(v) for c in caps]
    scores = _host(score_fn(e0, et, sentences)).reshape(v, k)
    true_idx = np.asarray([_dir_index(np.asarray(d)) for d in deltas])
    return float(np.mean(np.argmax(scores, axis=1) == true_idx))


def _render_frame(
    size: int,
    block: np.ndarray,
    goal: np.ndarray,
    bg: Tuple[np.ndarray, np.ndarray, np.ndarray],
    block_half: int,
    goal_radius: int,
) -> np.ndarray:
    """One [H, W, 3] uint8 frame: textured background + goal disk + block."""
    img = np.stack(bg, axis=-1).copy()
    yy, xx = np.mgrid[0:size, 0:size]
    # goal: green disk (static per video)
    gm = (xx - goal[0]) ** 2 + (yy - goal[1]) ** 2 <= goal_radius**2
    img[gm] = (40.0, 200.0, 60.0)
    # block: red square (drawn over the goal — the moving thing wins)
    bm = (np.abs(xx - block[0]) <= block_half) & (np.abs(yy - block[1]) <= block_half)
    img[bm] = (220.0, 50.0, 40.0)
    return img.clip(0, 255).astype(np.uint8)


def _background(size: int, rng: np.random.Generator):
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    chans = []
    for _ in range(3):
        fx, fy = rng.uniform(0.5, 2.0, 2)
        ph = rng.uniform(0, 2 * np.pi)
        chans.append(110.0 + 45.0 * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph))
    return tuple(chans)


def _video_geometry(size: int, rng: np.random.Generator, margin: int):
    """Random (start, goal) with a minimum travel distance."""
    while True:
        p0 = rng.uniform(margin, size - margin, 2)
        g = rng.uniform(margin, size - margin, 2)
        if np.linalg.norm(g - p0) >= size * 0.3:
            return p0, g


def write_probe_dataset(
    root: str,
    n_videos: int = 64,
    n_frames: int = 40,
    size: int = 224,
    seed: int = 0,
) -> str:
    """Ego4D-layout pretraining split of the reach world (+ vocab.txt).

    The manifest is written with the `csv` module (`r3m_tpu_torch.data.ego4d.
    write_manifest`), in the columns and quoting pandas' ``to_csv`` gives; the frames with
    Pillow at quality 90.
    """
    from PIL import Image

    from r3m_tpu_torch.data.ego4d import write_manifest

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    margin = max(12, size // 8)
    block_half = max(3, size // 12)
    goal_radius = max(3, size // 16)
    rows = []
    for v in range(n_videos):
        p0, g = _video_geometry(size, rng, margin)
        bg = _background(size, rng)
        vdir = os.path.join(root, f"vid{v:03}")
        os.makedirs(vdir, exist_ok=True)
        for t in range(n_frames):
            pos = p0 + (g - p0) * (t / (n_frames - 1))
            img = _render_frame(size, pos, g, bg, block_half, goal_radius)
            Image.fromarray(img).save(os.path.join(vdir, f"{t + 1:06}.jpg"), quality=90)
        phrase = _direction_phrase(g - p0)
        rows.append({"path": vdir, "len": n_frames,
                     "txt": f"C person moves the block to the {phrase}"})
    write_manifest(os.path.join(root, "manifest.csv"), rows)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(PROBE_VOCAB) + "\n")
    return root


def render_probe_set(
    n_videos: int = 24,
    n_frames: int = 30,
    size: int = 224,
    seed: int = 10_000,
) -> Dict[str, np.ndarray]:
    """Held-out in-memory probe set (use a seed disjoint from training).

    Returns dict:
      images   [N, 3, H, W] uint8 (NCHW — the R3MEncoder input law)
      actions  [N, 2] f32: unit vector block->goal (0 at the goal) — the BC regression
               target
      latents  [N, 4] f32: block x/y and goal x/y in [0, 1]
      progress [N] f32: fraction of the trajectory completed
      video    [N] int32: video id (grouping key; split by VIDEO, not frame)
    """
    rng = np.random.default_rng(seed)
    margin = max(12, size // 8)
    block_half = max(3, size // 12)
    goal_radius = max(3, size // 16)
    images, actions, latents, progress, video = [], [], [], [], []
    for v in range(n_videos):
        p0, g = _video_geometry(size, rng, margin)
        bg = _background(size, rng)
        for t in range(n_frames):
            frac = t / (n_frames - 1)
            pos = p0 + (g - p0) * frac
            img = _render_frame(size, pos, g, bg, block_half, goal_radius)
            images.append(np.transpose(img, (2, 0, 1)))  # HWC -> CHW
            delta = g - pos
            norm = np.linalg.norm(delta)
            actions.append(delta / norm if norm > 1e-6 else np.zeros(2))
            latents.append(np.concatenate([pos, g]) / size)
            progress.append(frac)
            video.append(v)
    return {
        "images": np.stack(images).astype(np.uint8),
        "actions": np.stack(actions).astype(np.float32),
        "latents": np.stack(latents).astype(np.float32),
        "progress": np.asarray(progress, np.float32),
        "video": np.asarray(video, np.int32),
    }


def reward_order_acc(emb: np.ndarray, video: np.ndarray) -> float:
    """Zero-shot temporal-ordering accuracy: sim(e_t, e_goal) monotone in t?

    The model's downstream reward semantics (−L2 `sim`, models_r3m.py:102-107 /
    `r3m_tpu_torch.models.r3m.sim` with l2dist=true): within each video, the fraction of
    ordered frame pairs (t1 < t2, both < T−1) whose −L2 similarity to the FINAL frame is
    correctly ordered, averaged over videos. No probe head is fitted — zero fitting
    variance; the purest "did TCN training shape the metric space" signal, and the
    in-space analogue of using `get_reward` as an RL reward (paper §4.3).
    """
    emb = _host(emb)
    accs = []
    for v in np.unique(video):
        e = np.asarray(emb[video == v], np.float64)
        d = -np.linalg.norm(e[:-1] - e[-1], axis=1)  # sim(e_t, e_T)
        ii, jj = np.triu_indices(d.shape[0], k=1)
        if ii.size == 0:
            continue  # <3 frames: no ordered pair; NaN must not propagate
        # ties score 0.5 (chance): a collapsed constant embedding carries no order signal
        # and must read ~0.5, not 0.0 "anti-ordered"
        accs.append(float(np.mean((d[jj] > d[ii]) + 0.5 * (d[jj] == d[ii]))))
    if not accs:
        raise ValueError("reward_order_acc needs at least one video with >= 3 frames")
    return float(np.mean(accs))


def linear_probe(
    emb: np.ndarray,
    target: np.ndarray,
    groups: Optional[np.ndarray] = None,
    val_frac: float = 0.25,
    ridge: float = 1e-3,
    seed: int = 0,
) -> Dict[str, float]:
    """Closed-form ridge regression probe; returns per-target val R².

    Splits by `groups` (video ids) when given — frames of one video must not straddle the
    split, or nearest-neighbour leakage inflates every encoder's score. R² = 1 −
    MSE/baseline: 0 is "predicts the train mean", 1 is perfect; random features land in
    between, and the pretrained-vs-random GAP is the representation-quality signal.
    """
    emb = np.asarray(_host(emb), np.float64)
    target = np.asarray(target, np.float64)
    if target.ndim == 1:
        target = target[:, None]
    n = emb.shape[0]
    rng = np.random.default_rng(seed)
    if groups is not None:
        ids = np.unique(groups)
        rng.shuffle(ids)
        n_val = max(1, int(len(ids) * val_frac))
        val_mask = np.isin(groups, ids[:n_val])
    else:
        order = rng.permutation(n)
        val_mask = np.zeros(n, bool)
        val_mask[order[: max(1, int(n * val_frac))]] = True

    mu, sd = emb[~val_mask].mean(0), emb[~val_mask].std(0) + 1e-8
    x_tr = (emb[~val_mask] - mu) / sd
    x_val = (emb[val_mask] - mu) / sd
    y_tr, y_val = target[~val_mask], target[val_mask]
    ymu = y_tr.mean(0)
    d = x_tr.shape[1]
    w = np.linalg.solve(
        x_tr.T @ x_tr + ridge * x_tr.shape[0] * np.eye(d),
        x_tr.T @ (y_tr - ymu),
    )
    pred = x_val @ w + ymu
    mse = np.mean((pred - y_val) ** 2, axis=0)
    # Baseline = the train-mean predictor, NOT Var(y_val): targets like the goal position
    # are constant within a video, so a small video-held-out val split can have ~zero
    # internal variance, and 1 - mse/Var(y_val) explodes to -1e11. Skill-vs-train-mean is
    # the stable, standard definition for grouped held-out R².
    var = np.mean((y_val - ymu) ** 2, axis=0) + 1e-12
    r2 = 1.0 - mse / var
    return {
        "r2_mean": float(np.mean(r2)),
        "r2_min": float(np.min(r2)),
        "val_mse": float(np.mean(mse)),
    }
