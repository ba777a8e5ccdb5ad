"""Kernels K1 and K2: MaxPool2d(3, stride 2, padding 1) over NHWC, the ResNet stem's pool,
forward (with its argmax) and backward.

Replaces the TPU kernel ``r3m_tpu/ops/pallas_pool.py`` (``_fwd_call`` and ``_bwd_call``
behind its custom-VJP ``maxpool_3x3s2``), and computes what the JAX stem computes at
``r3m_tpu/models/resnet.py:369`` (``max_pool_3x3s2``, a ``lax.reduce_window``) and its
gradient: odd H and W are accepted, a NaN propagates, and the gradient goes to the FIRST
maximum of each window in row-major window order (select-and-scatter's rule, which
``_amax_pool`` at ``resnet.py:157-208`` and the Pallas kernels share). The Hopper kernels
are in ``r3m_tpu_torch/csrc/maxpool.cu``; both are bound by memory, and their source says
more.

`maxpool_3x3s2` is the differentiable entry point (`MaxPool3x3s2Function`). Its forward
goes through `maxpool_3x3s2_fwd` (K1, which also writes an int8 argmax when the input
needs a gradient) and its backward through `maxpool_3x3s2_bwd` (K2). Each of those two
wrappers launches its kernel for CUDA tensors and counts the launch in its ``launches``
attribute; for CPU tensors it computes its plain PyTorch version,
`maxpool_3x3s2_reference` or `maxpool_3x3s2_bwd_reference`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from r3m_tpu_torch.ops._build import load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pooled_size(n: int) -> int:
    return (n - 1) // 2 + 1


def _window_valid(k: int, oh: int, ow: int, h: int, w: int, device) -> torch.Tensor:
    """[1, oh, ow, 1] mask: where window offset k reads the input and not the padding."""
    dh, dw = divmod(k, 3)
    rows = torch.arange(oh, device=device) * 2 + dh - 1
    cols = torch.arange(ow, device=device) * 2 + dw - 1
    ok_r = (rows >= 0) & (rows < h)
    ok_c = (cols >= 0) & (cols < w)
    return (ok_r[:, None] & ok_c[None, :])[None, :, :, None]


def maxpool_3x3s2_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch MaxPool2d(3, 2, 1) over NHWC and its argmax.

    The output is the max of nine strided views of the input padded with -inf
    (``reduce_window`` semantics, NaN included). The argmax (int8, window offset
    ``dh*3 + dw``) is the first offset, in window order, that holds the maximum (the
    first NaN where the maximum is NaN), never a padded one.
    """
    _, h, w, _ = x.shape
    oh, ow = pooled_size(h), pooled_size(w)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=float("-inf"))
    views = [xp[:, dh : dh + 2 * oh - 1 : 2, dw : dw + 2 * ow - 1 : 2, :]
             for dh in range(3) for dw in range(3)]
    y = views[0]
    for view in views[1:]:
        y = torch.maximum(y, view)
    y_nan = torch.isnan(y)
    idx = torch.full(y.shape, 4, dtype=torch.int8, device=x.device)  # 4 is always valid
    for k in range(8, -1, -1):  # downward, so the first offset that holds the max wins
        hit = (views[k] == y) | (torch.isnan(views[k]) & y_nan)
        idx.masked_fill_(hit & _window_valid(k, oh, ow, h, w, x.device), k)
    return y.contiguous(), idx


def maxpool_3x3s2_bwd_reference(
    idx: torch.Tensor, dy: torch.Tensor, h: int, w: int
) -> torch.Tensor:
    """Plain PyTorch backward: dx ``[N, h, w, C]`` in dy's dtype from the argmax and dy.

    Sums in f32, one window offset at a time in the order 0..8, which is the order in
    which K2 adds an input element's (at most four) contributions.
    """
    n, oh, ow, c = dy.shape
    g = dy.to(torch.float32)
    dxp = torch.zeros((n, h + 2, w + 2, c), dtype=torch.float32, device=dy.device)
    for k in range(9):
        dh, dw = divmod(k, 3)
        dxp[:, dh : dh + 2 * oh - 1 : 2, dw : dw + 2 * ow - 1 : 2, :] += torch.where(
            idx == k, g, 0.0
        )
    return dxp[:, 1 : h + 1, 1 : w + 1, :].to(dy.dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("maxpool")
    lib.r3m_maxpool3x3s2.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.r3m_maxpool3x3s2.restype = ctypes.c_int
    lib.r3m_maxpool3x3s2_bwd.argtypes = list(lib.r3m_maxpool3x3s2.argtypes)
    lib.r3m_maxpool3x3s2_bwd.restype = ctypes.c_int
    return lib


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda" or t.device != tensors[0].device:
            raise ValueError(f"{name} runs on one CUDA device or on the CPU, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous NHWC tensors")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def maxpool_3x3s2_fwd(
    x: torch.Tensor, argmax: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1: ``(y, idx)`` for an NHWC tensor ``[N, H, W, C]``.

    ``y`` is ``[N, (H-1)//2+1, (W-1)//2+1, C]`` in x's dtype; ``idx`` the int8 argmax of
    the same shape when `argmax` is set, else None. A CUDA tensor must be contiguous
    float32 or bfloat16; it goes through the Hopper kernel, never the plain version.
    """
    if x.ndim != 4:
        raise ValueError(f"expected NHWC [N, H, W, C], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        y, idx = maxpool_3x3s2_reference(x)
        return y, (idx if argmax else None)
    _check_cuda("maxpool_3x3s2", x)
    if x.dtype not in _DTYPES:
        raise TypeError(f"maxpool_3x3s2 takes float32 or bfloat16, got {x.dtype}")
    n, h, w, c = x.shape
    shape = (n, pooled_size(h), pooled_size(w), c)
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    idx = torch.empty(shape, dtype=torch.int8, device=x.device) if argmax else None
    if y.numel() == 0:
        return y, idx
    with torch.cuda.device(x.device):
        err = _lib().r3m_maxpool3x3s2(
            x.data_ptr(), y.data_ptr(), idx.data_ptr() if argmax else None,
            n, h, w, c, _DTYPES[x.dtype], _stream(x),
        )
    if err != 0:
        raise RuntimeError(f"maxpool_3x3s2 kernel launch failed: cudaError_t {err}")
    maxpool_3x3s2_fwd.launches += 1
    return y, idx


maxpool_3x3s2_fwd.launches = 0


def maxpool_3x3s2_bwd(idx: torch.Tensor, dy: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """K2: dx ``[N, h, w, C]`` in dy's dtype from K1's argmax and the output gradient.

    `h` and `w` are the forward input's, so odd sizes come back whole. CUDA tensors must
    be contiguous: dy float32 or bfloat16, idx int8, both ``[N, OH, OW, C]``.
    """
    n, oh, ow, c = dy.shape
    if idx.shape != dy.shape or (oh, ow) != (pooled_size(h), pooled_size(w)):
        raise ValueError(
            f"argmax {tuple(idx.shape)} and dy {tuple(dy.shape)} do not pool an input "
            f"of {h}x{w}"
        )
    if dy.device.type == "cpu" and idx.device.type == "cpu":
        return maxpool_3x3s2_bwd_reference(idx, dy, h, w)
    _check_cuda("maxpool_3x3s2_bwd", dy, idx)
    if dy.dtype not in _DTYPES or idx.dtype != torch.int8:
        raise TypeError(
            f"maxpool_3x3s2_bwd takes float32 or bfloat16 dy and an int8 argmax, got "
            f"{dy.dtype} and {idx.dtype}"
        )
    dx = torch.empty((n, h, w, c), dtype=dy.dtype, device=dy.device)
    if dx.numel() == 0:
        return dx
    with torch.cuda.device(dy.device):
        err = _lib().r3m_maxpool3x3s2_bwd(
            idx.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, h, w, c, _DTYPES[dy.dtype],
            _stream(dy),
        )
    if err != 0:
        raise RuntimeError(f"maxpool_3x3s2_bwd kernel launch failed: cudaError_t {err}")
    maxpool_3x3s2_bwd.launches += 1
    return dx


maxpool_3x3s2_bwd.launches = 0


class MaxPool3x3s2Function(torch.autograd.Function):
    """K1 forward, K2 backward. Saves only the int8 argmax, and only under grad."""

    @staticmethod
    def forward(ctx, x):
        needs_grad = ctx.needs_input_grad[0]
        y, idx = maxpool_3x3s2_fwd(x, argmax=needs_grad)
        if needs_grad:
            ctx.save_for_backward(idx)
            ctx.in_hw = (x.shape[1], x.shape[2])
        return y

    @staticmethod
    def backward(ctx, dy):
        (idx,) = ctx.saved_tensors
        return maxpool_3x3s2_bwd(idx, dy.contiguous(), *ctx.in_hw)


def maxpool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, stride 2, padding 1) over an NHWC tensor ``[N, H, W, C]``, with a
    gradient that goes to the first maximum of each window."""
    if x.ndim != 4:
        raise ValueError(f"expected NHWC [N, H, W, C], got {tuple(x.shape)}")
    return MaxPool3x3s2Function.apply(x)
