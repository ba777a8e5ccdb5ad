"""Batched JPEG decoding on the host: ctypes binding to the native decode stage.

The port of ``r3m_tpu/data/decoder.py``. It binds the repo's ``csrc/jpeg_decoder.cpp`` (a
libjpeg thread pool decoding straight into caller-owned buffers, with box resizing to the
output size), which `r3m_tpu_torch.ops._build.load_decoder` compiles into
``r3m_tpu_torch/build/`` at first use; the JAX package's prebuilt library is never loaded.
Where the library cannot be built (no C++ compiler, no libjpeg headers) decoding falls
back to PIL (``Image.BOX`` resizing, one thread), as in the JAX package. The fallback is
never silent: the reason is printed once, `JpegDecoder.native` says which decoder runs
and `decoder_status` gives both for a caller to report.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

# The reference samples 5 frames per clip (start, end, s0, s1, s2 — data_loaders.py:75-79);
# batch layouts everywhere are [B, 5, H, W, 3].
FRAMES_PER_CLIP = 5

_warned_batches = 0
_lib_memo: List = []  # [(library or None, reason)] once a load was attempted


def _warn_failed(failed: int, n: int, limit: int = 20) -> None:
    """Report decode failures (zero-filled frames), rate-limited.

    A failed frame is zero-filled rather than fatal (one corrupt JPEG must not end a long
    pretraining run), but silence would hide a bad manifest (a ``len`` past the real frame
    count), so every failing batch warns until the limit.
    """
    global _warned_batches
    if failed > 0 and _warned_batches < limit:
        _warned_batches += 1
        print(
            f"[decoder] {failed}/{n} frames failed to decode (zero-filled) "
            f"— check manifest lengths / JPEG integrity"
            + (" [further warnings suppressed]" if _warned_batches == limit else "")
        )


def _load_library() -> Tuple[Optional[ctypes.CDLL], str]:
    """``(library, "")``, or ``(None, reason)`` where it cannot be built; one attempt a
    process, and the reason is printed once."""
    if not _lib_memo:
        from r3m_tpu_torch.ops import _build

        try:
            lib, reason = _bind(_build.load_decoder()), ""
        except RuntimeError as e:
            lines = [line.strip() for line in str(e).splitlines() if line.strip()]
            error = next((line for line in lines[1:]
                          if "error" in line or "cannot find" in line), "")
            lib, reason = None, " ".join(lines[:1] + [error])[:400]
            print(f"[decoder] native JPEG library unavailable ({reason}); "
                  "decoding with PIL (Image.BOX, one thread)")
        _lib_memo.append((lib, reason))
    return _lib_memo[0]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.r3m_decoder_create.restype = ctypes.c_void_p
    lib.r3m_decoder_create.argtypes = [ctypes.c_int]
    lib.r3m_decoder_destroy.restype = None
    lib.r3m_decoder_destroy.argtypes = [ctypes.c_void_p]
    lib.r3m_decode_batch.restype = ctypes.c_int
    lib.r3m_decode_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.r3m_pipeline_create.restype = ctypes.c_void_p
    lib.r3m_pipeline_create.argtypes = [ctypes.c_int] * 5
    lib.r3m_pipeline_destroy.restype = None
    lib.r3m_pipeline_destroy.argtypes = [ctypes.c_void_p]
    lib.r3m_pipeline_submit.restype = ctypes.c_int
    lib.r3m_pipeline_submit.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
    ]
    lib.r3m_pipeline_fetch.restype = ctypes.c_int
    lib.r3m_pipeline_fetch.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    return lib


def decoder_status() -> Tuple[str, str]:
    """``("native", "")``, or ``("pil", why the native library is unavailable)``."""
    lib, reason = _load_library()
    return ("native", "") if lib is not None else ("pil", reason)


class JpegDecoder:
    """Decode batches of JPEG paths into ``[N, H, W, 3]`` uint8 arrays."""

    def __init__(self, height: int = 224, width: int = 224, n_threads: Optional[int] = None):
        self.height = height
        self.width = width
        if n_threads is None:
            n_threads = max(1, (os.cpu_count() or 1))
        self._lib, _ = _load_library()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.r3m_decoder_create(n_threads)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def decode_batch(self, paths: Sequence[str], out: Optional[np.ndarray] = None) -> np.ndarray:
        n = len(paths)
        if out is None:
            out = np.empty((n, self.height, self.width, 3), dtype=np.uint8)
        # explicit raises, not asserts (stripped under `python -O`): a wrong buffer would
        # be a native heap overflow. The native path writes row-major, so the buffer must
        # be C-contiguous.
        if out.shape != (n, self.height, self.width, 3) or out.dtype != np.uint8:
            raise ValueError(
                f"out must be uint8 {(n, self.height, self.width, 3)}, "
                f"got {out.dtype} {out.shape}"
            )
        if not out.flags["C_CONTIGUOUS"]:
            raise ValueError("out must be C-contiguous")
        if self._handle is not None:
            arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
            failed = self._lib.r3m_decode_batch(
                self._handle, arr, n,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self.height, self.width,
            )
            _warn_failed(failed, n)
            return out
        return self._decode_batch_pil(paths, out)

    def _decode_batch_pil(self, paths: Sequence[str], out: np.ndarray) -> np.ndarray:
        from PIL import Image

        failed = 0
        for i, p in enumerate(paths):
            try:
                with Image.open(p) as im:
                    im = im.convert("RGB")
                    if im.size != (self.width, self.height):
                        im = im.resize((self.width, self.height), Image.BOX)
                    out[i] = np.asarray(im)
            except Exception:  # any unreadable file is zero-filled and counted
                out[i] = 0
                failed += 1
        _warn_failed(failed, len(paths))
        return out

    def __del__(self):
        if getattr(self, "_handle", None) is not None and self._lib is not None:
            self._lib.r3m_decoder_destroy(self._handle)
            self._handle = None


class NativeFramePipeline:
    """Native prefetch pipeline: C++ owns decoding and batch assembly.

    The same ``next_batch()`` surface as `r3m_tpu_torch.data.ego4d.FrameBatcher`: `depth`
    batches of frame paths are submitted ahead, a C++ thread pool decodes them into a ring
    of staging buffers, and `next_batch()` copies out the next finished batch in submit
    order, with no Python thread between submit and fetch. Captions ride a host-side list
    in the same order. Raises `RuntimeError` where the native library is unavailable.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        height: int = 224,
        width: int = 224,
        n_threads: Optional[int] = None,
        depth: int = 3,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.height, self.width = height, width
        if n_threads is None:
            n_threads = max(1, (os.cpu_count() or 1))
        lib, reason = _load_library()
        if lib is None:
            raise RuntimeError(f"native pipeline unavailable: {reason}")
        self._lib = lib
        self._frames = batch_size * FRAMES_PER_CLIP
        self._handle = lib.r3m_pipeline_create(n_threads, self._frames, height, width, depth)
        if not self._handle:  # the C side refuses degenerate dimensions
            raise ValueError(
                f"invalid pipeline dims: batch_size={batch_size}, "
                f"height={height}, width={width}"
            )
        self._captions: List[List[str]] = []
        for _ in range(depth):
            self._submit_one()

    def _submit_one(self):
        if self._handle is None:
            # a NULL handle passed to C would be dereferenced
            raise RuntimeError("pipeline is closed")
        paths, captions = self.dataset.sample_batch(self.batch_size)
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        rc = self._lib.r3m_pipeline_submit(self._handle, arr, len(paths))
        if rc != 0:
            raise RuntimeError(f"pipeline submit failed (rc={rc})")
        self._captions.append(captions)

    def next_batch(self):
        """``([B, 5, H, W, 3] uint8, captions)``; blocks on the C++ ring.

        The fetch copies the ring slot into a fresh array the caller owns (a reused
        buffer would alias batches a prefetch queue still holds)."""
        if self._handle is None:
            raise RuntimeError("pipeline is closed")
        buf = np.empty((self._frames, self.height, self.width, 3), np.uint8)
        failed = self._lib.r3m_pipeline_fetch(
            self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        )
        if failed < 0:
            raise RuntimeError("pipeline fetch with nothing in flight")
        _warn_failed(failed, self._frames)
        captions = self._captions.pop(0)
        clips = buf.reshape(self.batch_size, FRAMES_PER_CLIP, self.height, self.width, 3)
        self._submit_one()  # keep the ring full
        return clips, captions

    def close(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.r3m_pipeline_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
