"""`r3m_tpu_torch.models.layers.layer_norm` on the card: one kernel a direction, with the
composition's law (f32 statistics, f32 weight and bias, one rounding to x's dtype).

It replaces no TPU kernel. The JAX LayerNorm is a composition that XLA fuses into one
pass; the port's eager composition (`layer_norm_reference`) runs ~11 kernels over f32
copies of the rows, and autograd keeps three of those copies for the backward.
``r3m_tpu_torch/csrc/layer_norm.cu`` reads a row once and writes it once, and keeps only
each row's mean and rstd for the backward; its source says more.

`layer_norm_fwd` and `layer_norm_bwd` launch the kernels for CUDA tensors, counting each
call in their ``launches`` attribute (the backward's call launches its column sum too),
and raise a ValueError for CUDA operands the kernels cannot take; for CPU tensors they
compute their plain versions, `layer_norm_reference` and `layer_norm_bwd_reference`, and
launch nothing. `norm_rows` copies a view whose rows the kernels cannot read in place.
ATen's own CUDA ``layer_norm`` takes the weight and bias in x's dtype, so in bf16 it
would round them before use: another function.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from r3m_tpu_torch.ops._build import load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TOO_WIDE = -2
_NEEDS_WORKSPACE = -3


def layer_norm_reference(x2: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The composition, op for op: ``(y, mean, rstd)`` for rows ``x2 [R, D]``, the mean
    and the variance ``mean((x - mean)^2)`` in f32, ``y = (x - mean) * rstd * weight +
    bias`` in f32 rounded once to x2's dtype; mean and rstd f32 ``[R]``."""
    xf = x2.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mu) * rstd * weight + bias
    return y.to(x2.dtype), mu.squeeze(-1), rstd.squeeze(-1)


def layer_norm_bwd_reference(g: torch.Tensor, x2: torch.Tensor, mean: torch.Tensor,
                             rstd: torch.Tensor, weight: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dw, db)`` for the output gradient ``g [R, D]``, written out in f32:
    ``dx = rstd * (g*w - mean(g*w) - xhat * mean(g*w*xhat))`` rounded once to x2's dtype,
    ``dw`` the f32 sum over the rows of ``g * xhat``, ``db`` that of ``g``."""
    xhat = (x2.to(torch.float32) - mean[:, None]) * rstd[:, None]
    gf = g.to(torch.float32)
    gw = gf * weight
    a = gw.mean(dim=-1, keepdim=True)
    c = (gw * xhat).mean(dim=-1, keepdim=True)
    dx = rstd[:, None] * (gw - a - xhat * c)
    return dx.to(x2.dtype), (gf * xhat).sum(dim=0), gf.sum(dim=0)


def norm_rows(x2: torch.Tensor) -> torch.Tensor:
    """``x2 [R, D]`` itself where the kernels can read its rows in place (unit stride along
    a row, a row stride of at least D), else a contiguous copy. Where D, the row stride or
    the start does not allow 16-byte vectors the kernels read one element at a time."""
    s0, s1 = x2.stride()
    if (s1 == 1 or x2.shape[1] <= 1) and s0 >= x2.shape[1]:
        return x2
    return x2.contiguous()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("layer_norm")
    i32, i64, ptr, size = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_size_t
    lib.r3m_layer_norm_fwd.argtypes = [ptr, i64, ptr, ptr, ptr, ptr, ptr, i64, i64,
                                       ctypes.c_float, i32, i32, ptr]
    lib.r3m_layer_norm_fwd.restype = i32
    lib.r3m_layer_norm_bwd.argtypes = [ptr, ptr, i64, ptr, ptr, ptr, ptr, ptr, ptr, ptr, size,
                                       ctypes.POINTER(size), i64, i64, i32, i32, ptr]
    lib.r3m_layer_norm_bwd.restype = i32
    return lib


def _check(name: str, x2: torch.Tensor, *params: torch.Tensor) -> int:
    """The dtype code of x2 for the kernels, or a ValueError for what they cannot take."""
    d = x2.shape[1]
    if (x2.dtype not in _DTYPES or x2.stride(1) != 1 and d > 1
            or any(p.dtype != torch.float32 or p.shape != (d,) or not p.is_contiguous()
                   or p.device != x2.device for p in params)):
        raise ValueError(
            f"{name} takes f32 or bf16 rows [R, D] of unit stride along a row and f32 "
            f"contiguous parameters [D] on the same device; got x {tuple(x2.shape)} "
            f"{x2.dtype} stride {x2.stride()}, parameters "
            f"{[(tuple(p.shape), p.dtype, str(p.device)) for p in params]}")
    return _DTYPES[x2.dtype]


def _too_wide(name: str, d: int) -> ValueError:
    return ValueError(
        f"{name}: rows of {d} elements are wider than the kernel holds (1,024 16-byte "
        f"vectors: 8,192 bf16 or 4,096 f32; 1,024 elements where a row is not whole "
        f"aligned vectors)")


def layer_norm_fwd(x2: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                   lead: Optional[Sequence[int]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, mean, rstd)`` of LayerNorm over the rows ``x2 [R, D]`` (f32 or bf16): y in
    x2's dtype, shaped ``[*lead, D]`` where `lead` is given, else ``[R, D]``; mean and
    rstd f32 ``[R]``. On the card, x2's rows as `norm_rows` returns them and the weight
    and bias f32, contiguous, ``[D]``; else a ValueError, as for a D the kernel cannot
    hold."""
    rows = x2.shape[:1] if lead is None else tuple(lead)
    d = x2.shape[1]
    if not x2.is_cuda:
        y, mean, rstd = layer_norm_reference(x2, weight, bias, eps)
        return y.reshape(*rows, d), mean, rstd
    dtype = _check("layer_norm_fwd", x2, weight, bias)
    r = x2.shape[0]
    y = torch.empty((*rows, d), dtype=x2.dtype, device=x2.device)
    mean, rstd = torch.empty((2, r), dtype=torch.float32, device=x2.device)
    if y.numel():
        device = x2.get_device()
        err = _lib().r3m_layer_norm_fwd(
            x2.data_ptr(), x2.stride(0), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), r, d, eps, dtype, device,
            torch._C._cuda_getCurrentRawStream(device))
        if err == _TOO_WIDE:
            raise _too_wide("layer_norm_fwd", d)
        if err:
            raise RuntimeError(f"the layer_norm forward kernel failed: error {err}")
        layer_norm_fwd.launches += 1
    return y, mean, rstd


layer_norm_fwd.launches = 0

_workspaces = {}  # (device, stream): the f32 partial sums the backward on that stream reuses


def layer_norm_bwd(g: torch.Tensor, x2: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                   weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dw, db)`` for the output gradient ``g [R, D]`` of `layer_norm_fwd` at x2,
    from its mean and rstd: dx ``[R, D]`` in x2's dtype, dw and db f32 ``[D]``. On the
    card g contiguous in x2's dtype, the rest as `layer_norm_fwd` takes them."""
    if not g.is_cuda:
        return layer_norm_bwd_reference(g, x2, mean, rstd, weight)
    dtype = _check("layer_norm_bwd", x2, weight)
    r, d = x2.shape
    if (g.dtype != x2.dtype or g.shape != x2.shape or not g.is_contiguous()
            or g.device != x2.device
            or any(s.dtype != torch.float32 or s.shape != (r,) or not s.is_contiguous()
                   for s in (mean, rstd))):
        raise ValueError(
            f"layer_norm_bwd takes a contiguous g of x's dtype and shape and f32 mean and "
            f"rstd [R]; got g {tuple(g.shape)} {g.dtype}, x {tuple(x2.shape)} {x2.dtype}")
    dx = torch.empty((r, d), dtype=x2.dtype, device=x2.device)
    dw = torch.empty(d, dtype=torch.float32, device=x2.device)
    db = torch.empty(d, dtype=torch.float32, device=x2.device)
    if not dx.numel():
        return dx, dw.zero_(), db.zero_()
    device = x2.get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    need = ctypes.c_size_t(0)

    def launch(work):
        return _lib().r3m_layer_norm_bwd(
            g.data_ptr(), x2.data_ptr(), x2.stride(0), mean.data_ptr(), rstd.data_ptr(),
            weight.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
            None if work is None else work.data_ptr(),
            0 if work is None else work.numel() * 4, ctypes.byref(need), r, d, dtype,
            device, stream)

    work = _workspaces.get((device, stream))
    err = launch(work)
    if err == _NEEDS_WORKSPACE:  # grown, never shrunk: a step's shapes come back
        size = max((need.value + 3) // 4, 0 if work is None else work.numel())
        work = _workspaces[(device, stream)] = torch.empty(
            size, dtype=torch.float32, device=x2.device)
        err = launch(work)
    if err == _TOO_WIDE:
        raise _too_wide("layer_norm_bwd", d)
    if err:
        raise RuntimeError(f"the layer_norm backward kernels failed: error {err}")
    layer_norm_bwd.launches += 1
    return dx, dw, db


layer_norm_bwd.launches = 0
