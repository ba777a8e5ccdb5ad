"""Ego4D clips: the manifest, the frame-index sampling law and batch assembly.

The port of ``r3m_tpu/data/ego4d.py``, which follows the reference's `R3MBuffer`
(``r3m/utils/data_loaders.py:38-109``):

* ``manifest.csv`` has the columns ``path`` (a folder of frames), ``len`` (its frame
  count) and ``txt`` (the narration, whose leading ``"C "`` is cut off by ``txt[2:]``);
* a clip's frames are the 1-based files ``{path}/{index:06}.jpg`` at
      start  ~ U[1, 2 + int(alpha*len))
      end    ~ U[int((1-alpha)*len) - 1, len)
      s1     ~ U[2, len)
      s0     ~ U[1, s1)
      s2     ~ U[s1, len + 1)
  (data_loaders.py:75-79), drawn from a numpy ``default_rng`` in the JAX package's order,
  so the same manifest, alpha and seed give the same stream of paths and captions;
* a batch is ``([B, 5, H, W, 3] uint8 frames in the order (start, end, s0, s1, s2),
  captions)``, the (e0, eg, es0, es1, es2) order the losses expect.

The manifest is read and written with the standard `csv` module: an empty ``txt`` cell,
or one that pandas reads as missing (``NA``, ``nan``, ...), is the empty caption, as
``pd.isna`` makes it in the JAX package; ``len`` may be written ``12`` or ``12.0``.
"""

from __future__ import annotations

import csv
import dataclasses
import hashlib
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from r3m_tpu_torch.data.decoder import FRAMES_PER_CLIP, JpegDecoder

MANIFEST_COLUMNS = ("path", "len", "txt")
# The cells pandas' read_csv takes for a missing value by default.
_MISSING_CELLS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


@dataclasses.dataclass
class ClipSample:
    paths: List[str]  # 5 frame file paths
    caption: str


def read_manifest(path: str) -> List[Dict]:
    """The rows of a ``manifest.csv``: ``{"path": str, "len": number, "txt": str}``."""
    rows = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        missing = set(MANIFEST_COLUMNS) - set(reader.fieldnames or ())
        if missing:
            raise ValueError(f"{path}: manifest lacks the columns {sorted(missing)}")
        for i, row in enumerate(reader):
            try:
                n = float(row["len"])
            except (TypeError, ValueError):
                raise ValueError(f"{path}: row {i} has len {row['len']!r}, not a number")
            txt = row["txt"]
            rows.append({"path": row["path"], "len": int(n) if n.is_integer() else n,
                         "txt": "" if txt is None or txt in _MISSING_CELLS else txt})
    return rows


def write_manifest(path: str, rows: Sequence[Mapping]) -> None:
    """Write rows as a ``manifest.csv`` (the columns and quoting pandas' ``to_csv`` gives)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(MANIFEST_COLUMNS)
        for row in rows:
            writer.writerow([row[k] for k in MANIFEST_COLUMNS])


class Ego4DDataset:
    """Manifest-backed clip sampler (host side, numpy generator).

    `seed` seeds this dataset's generator. A job of several hosts gives host ``i`` the
    manifest rows ``i::num_shards`` and the seed ``base + i`` (as the JAX workspace does),
    so ``seed - shard_index`` is the job's base seed, which `stream_fingerprint` names.
    """

    def __init__(
        self,
        datapath: str,
        alpha: float = 0.2,
        seed: int = 0,
        manifest: Optional[Sequence[Mapping]] = None,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        if manifest is None:
            manifest = read_manifest(os.path.join(datapath, "manifest.csv"))
        manifest = list(manifest)
        bad = [r["path"] for r in manifest if r["len"] < 3]
        if bad:
            # the index law (s1 ~ U[2, len)) needs len >= 3; the reference crashes
            # mid-training on such rows. Checked before sharding, so that every host of a
            # job fails alike.
            raise ValueError(
                f"manifest rows with len < 3 cannot be sampled: "
                f"{bad[:5]}{'...' if len(bad) > 5 else ''}"
            )
        self.alpha = alpha
        self._base_seed = seed - shard_index
        self._all_lens = [int(r["len"]) for r in manifest]
        if num_shards > 1:
            # a shard with no rows would fail only on its own host
            if len(manifest) < num_shards:
                raise ValueError(
                    f"manifest has {len(manifest)} rows but num_shards="
                    f"{num_shards}: every host shard needs at least one clip"
                )
            manifest = manifest[shard_index::num_shards]
        self.manifest = manifest
        self.rng = np.random.default_rng(seed)
        self._paths = [str(r["path"]) for r in manifest]
        self._lens = [int(r["len"]) for r in manifest]
        self._txts = [str(r["txt"]) for r in manifest]

    def __len__(self) -> int:
        return len(self.manifest)

    def stream_fingerprint(self) -> str:
        """Identity of the draw sequence this dataset's job produces.

        `skip_batches` replays draws whose bounds come from the ``len`` column, alpha and
        the seed, so a resume may fast-forward only against the same three. The hash
        covers the job's base seed, alpha, the row count and the whole manifest's ``len``
        column (before sharding): every host of a job has the same fingerprint, and
        moving the dataset to another folder keeps it. It covers no path. The workspace
        stores it in a snapshot's metadata and transfers the stream counters only when it
        matches.
        """
        h = hashlib.sha1()
        h.update(f"alpha={self.alpha!r};seed={self._base_seed};rows={len(self._all_lens)};"
                 .encode())
        h.update(";".join(map(str, self._all_lens)).encode())
        return h.hexdigest()[:16]

    def sample_indices(self, vidlen: int) -> Tuple[int, int, int, int, int]:
        """The index law of data_loaders.py:75-79 (1-based frames)."""
        rng = self.rng
        start_ind = int(rng.integers(1, 2 + int(self.alpha * vidlen)))
        end_ind = int(rng.integers(max(int((1 - self.alpha) * vidlen) - 1, 1), vidlen))
        s1_ind = int(rng.integers(2, vidlen))
        s0_ind = int(rng.integers(1, s1_ind))
        s2_ind = int(rng.integers(s1_ind, vidlen + 1))
        return start_ind, end_ind, s0_ind, s1_ind, s2_ind

    def sample_clip(self) -> ClipSample:
        vidid = int(self.rng.integers(0, len(self._paths)))
        vidlen = self._lens[vidid]
        caption = self._txts[vidid][2:]  # cuts the leading "C " (data_loaders.py:72)
        vid = self._paths[vidid]
        inds = self.sample_indices(vidlen)
        return ClipSample(paths=[os.path.join(vid, f"{i:06}.jpg") for i in inds],
                          caption=caption)

    def skip_batches(self, n_batches: int, batch_size: int) -> None:
        """Fast-forward the generator as if `n_batches` had been drawn.

        A resumed run replays the draws the interrupted run consumed, so it continues the
        stream an uninterrupted run would have drawn (the reference reseeds its loader
        workers on restart and changes the stream). The replay follows `sample_clip` draw
        for draw: the video, then its five indices, whose bounds depend on the video.
        """
        for _ in range(n_batches * batch_size):
            vidid = int(self.rng.integers(0, len(self._paths)))
            self.sample_indices(self._lens[vidid])

    def sample_batch(self, batch_size: int) -> Tuple[List[str], List[str]]:
        """``(5*B flat frame paths, B captions)``."""
        paths: List[str] = []
        captions: List[str] = []
        for _ in range(batch_size):
            c = self.sample_clip()
            paths.extend(c.paths)
            captions.append(c.caption)
        return paths, captions


class FrameBatcher:
    """sample -> decode -> ``[B, 5, H, W, 3]`` uint8 batch, one batch a call.

    Each call decodes into a fresh array the caller owns (a reused staging buffer would
    alias batches that a prefetch queue still holds).
    """

    def __init__(
        self,
        dataset: Ego4DDataset,
        batch_size: int,
        height: int = 224,
        width: int = 224,
        n_threads: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.decoder = JpegDecoder(height, width, n_threads)

    def next_batch(self) -> Tuple[np.ndarray, List[str]]:
        paths, captions = self.dataset.sample_batch(self.batch_size)
        frames = self.decoder.decode_batch(paths)
        return frames.reshape(self.batch_size, FRAMES_PER_CLIP, *frames.shape[1:]), captions


def write_synthetic_dataset(
    root: str,
    n_videos: int = 8,
    min_len: int = 12,
    max_len: int = 40,
    size: int = 224,
    seed: int = 0,
    captions: Optional[Sequence[str]] = None,
) -> str:
    """Write a synthetic Ego4D-layout dataset (``manifest.csv`` and JPEG frames) to
    `root`, the JAX package's fixture draw for draw.

    Each frame is a smooth moving gradient, so JPEG encodes it fast and crops stay
    distinguishable.
    """
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    rows = []
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for v in range(n_videos):
        vlen = int(rng.integers(min_len, max_len + 1))
        vdir = os.path.join(root, f"vid{v:03}")
        os.makedirs(vdir, exist_ok=True)
        phase = rng.uniform(0, 2 * np.pi)
        for t in range(1, vlen + 1):
            shift = t / vlen
            img = np.stack(
                [
                    127 + 120 * np.sin(2 * np.pi * (xx + shift) + phase),
                    127 + 120 * np.cos(2 * np.pi * (yy - shift) + phase),
                    127 + 120 * np.sin(2 * np.pi * (xx + yy + shift)),
                ],
                axis=-1,
            ).clip(0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(vdir, f"{t:06}.jpg"), quality=85)
        cap = captions[v % len(captions)] if captions else f"C person moves object {v}"
        # txt is read as txt[2:] (the Ego4D "C " narrator prefix, data_loaders.py:72):
        # make sure the prefix is there, so the caller's caption survives the cut
        if not cap.startswith("C "):
            cap = "C " + cap
        rows.append({"path": vdir, "len": vlen, "txt": cap})
    write_manifest(os.path.join(root, "manifest.csv"), rows)
    return root
