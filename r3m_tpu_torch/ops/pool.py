"""Kernel K1: MaxPool2d(3, stride 2, padding 1) over NHWC, the ResNet stem's pool.

Replaces the forward of the TPU kernel ``r3m_tpu/ops/pallas_pool.py`` (``_fwd_call`` /
``_fwd_kernel``, public ``maxpool_3x3s2``), and computes what the JAX stem computes at
``r3m_tpu/models/resnet.py:639`` (``max_pool_3x3s2``, a ``lax.reduce_window``): odd H
and W are accepted and a NaN propagates, as in ``reduce_window``. The Hopper kernel is
``r3m_tpu_torch/csrc/maxpool.cu``; it is bound by memory (one read of the input, one
write of the output) and reads channels_last rows with neighbouring threads on
neighbouring channels. Its source says more.

`maxpool_3x3s2` launches that kernel for a CUDA tensor and counts the launch in
``maxpool_3x3s2.launches``; for a CPU tensor it computes `maxpool_3x3s2_reference`, the
plain PyTorch version of the same function.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from r3m_tpu_torch.ops._build import load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pooled_size(n: int) -> int:
    return (n - 1) // 2 + 1


def maxpool_3x3s2_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch MaxPool2d(3, 2, 1) over NHWC: the max of nine strided views of the
    input padded with -inf (``reduce_window`` semantics, NaN included)."""
    _, h, w, _ = x.shape
    oh, ow = pooled_size(h), pooled_size(w)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=float("-inf"))
    y = None
    for dh in range(3):
        for dw in range(3):
            view = xp[:, dh : dh + 2 * oh - 1 : 2, dw : dw + 2 * ow - 1 : 2, :]
            y = view if y is None else torch.maximum(y, view)
    return y.contiguous()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("maxpool")
    lib.r3m_maxpool3x3s2.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.r3m_maxpool3x3s2.restype = ctypes.c_int
    return lib


def maxpool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, stride 2, padding 1) over an NHWC tensor ``[N, H, W, C]``.

    Output ``[N, (H-1)//2+1, (W-1)//2+1, C]`` in the input dtype. A CUDA tensor must be
    contiguous float32 or bfloat16; it goes through the Hopper kernel, never through
    the plain version.
    """
    if x.ndim != 4:
        raise ValueError(f"expected NHWC [N, H, W, C], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return maxpool_3x3s2_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"maxpool_3x3s2 runs on CUDA or CPU tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"maxpool_3x3s2 takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("maxpool_3x3s2 needs a contiguous NHWC tensor")
    n, h, w, c = x.shape
    y = torch.empty((n, pooled_size(h), pooled_size(w), c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        err = _lib().r3m_maxpool3x3s2(
            x.data_ptr(), y.data_ptr(), n, h, w, c, _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"maxpool_3x3s2 kernel launch failed: cudaError_t {err}")
    maxpool_3x3s2.launches += 1
    return y


maxpool_3x3s2.launches = 0
