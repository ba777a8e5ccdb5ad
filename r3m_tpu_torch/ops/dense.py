"""The bf16 products of `r3m_tpu_torch.models.layers.dense` with their epilogue inside the
GEMM: the forward ``round_bf16(x @ w.T + b)`` with the f32 bias added to the f32
accumulator before the one rounding, and the backward's ``round_bf16(g @ w)``.

It replaces no TPU kernel. The JAX ``dense`` is a product with an f32 result plus the f32
bias, then a cast, which XLA fuses; the port's unfused order (`dense_reference`) writes the
f32 product to device memory, adds the bias in another pass and casts in a third.
``r3m_tpu_torch/csrc/dense.cu`` runs both products as CUTLASS 3 Hopper GEMMs whose
epilogue adds the f32 bias to the f32 accumulator and rounds once (cuBLASLt refuses an f32
bias with a bf16 output, `cublaslt_takes_f32_bias`), and says more.

`dense_fwd` and `dense_dx` launch the products for CUDA tensors, counting each launch in
their ``launches`` attribute, and raise a ValueError for CUDA operands the products cannot
take; for CPU tensors they compute their plain versions, `dense_reference` and
`dense_dx_reference`. `gemm_rows` copies a view whose rows the products cannot read in
place. A call checks its operands once, here; the library checks each problem size once
and launches with one ctypes call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from r3m_tpu_torch.ops._build import load

FORWARD, DX = 0, 1
_ALIGN = 16  # bytes, of every pointer the product reads or writes


def dense_reference(x2: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The unfused order: ``x2 @ w.T`` with an f32 result, plus the f32 bias, cast to
    x2's dtype."""
    out = torch.mm(x2.to(torch.float32), w.to(torch.float32).t())
    return (out + bias.to(torch.float32)).to(x2.dtype)


def dense_dx_reference(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``g @ w`` with an f32 result, cast to g's dtype."""
    return torch.mm(g.to(torch.float32), w.to(torch.float32)).to(g.dtype)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``csrc/dense.cu``."""
    i32, i64, ptr, size = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_size_t
    lib.r3m_dense_workspace_bytes.argtypes = [i32, i64, i64, i64, i32]
    lib.r3m_dense_workspace_bytes.restype = size
    lib.r3m_dense_fwd.argtypes = [ptr, i64, ptr, ptr, ptr, i64, i64, i64, ptr, size, i32, ptr]
    lib.r3m_dense_fwd.restype = i32
    lib.r3m_dense_dx.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr, size, i32, ptr]
    lib.r3m_dense_dx.restype = i32
    lib.r3m_dense_cublaslt_f32_bias.argtypes = []
    lib.r3m_dense_cublaslt_f32_bias.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    return bind(load("dense"))


def cublaslt_takes_f32_bias() -> int:
    """cuBLASLt's answer, on this card, to whether its bias epilogue takes an f32 bias with
    a bf16 output (bf16 operands, f32 accumulation): 0 where its heuristic offers an
    algorithm, else the status it returned (-1: none offered). Needs the card."""
    return _lib().r3m_dense_cublaslt_f32_bias()


def gemm_rows(x2: torch.Tensor) -> torch.Tensor:
    """``x2 [M, K]`` itself where the products can read its rows in place (unit stride
    along a row, a row stride that is a multiple of 8 elements and at least K, a 16-byte
    aligned start, as TMA needs), else a contiguous copy."""
    s0, s1 = x2.stride()
    if s1 == 1 and s0 % 8 == 0 and s0 >= x2.shape[1] and x2.data_ptr() % _ALIGN == 0:
        return x2
    return x2.clone(memory_format=torch.contiguous_format)


_NEEDS_WORKSPACE = -3
_workspaces = {}  # (device, stream): the workspace the products on that stream share


def _launch(fn, kind: int, device: int, m: int, n: int, k: int, *pointers) -> None:
    """Launch `fn` (``r3m_dense_fwd`` or ``r3m_dense_dx``) on `device`'s current stream,
    with that stream's workspace, grown here the first time a product needs more."""
    stream = torch._C._cuda_getCurrentRawStream(device)
    work = _workspaces.get((device, stream))
    size = 0 if work is None else work.numel()
    err = fn(*pointers, m, n, k, None if work is None else work.data_ptr(), size, device,
             stream)
    if err == _NEEDS_WORKSPACE:
        size = _lib().r3m_dense_workspace_bytes(kind, m, n, k, device)
        work = _workspaces[(device, stream)] = torch.empty(
            size, dtype=torch.uint8, device=torch.device("cuda", device))
        err = fn(*pointers, m, n, k, work.data_ptr(), size, device, stream)
    if err:
        raise RuntimeError(f"the dense product failed: error {err}")


def dense_fwd(x2: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              lead: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``round_bf16(x2 @ w.T + bias)`` for ``x2 [M, K]`` and ``w [N, K]`` in bf16 and an f32
    ``bias [N]``: the f32 bias added to the f32 accumulator, one rounding; shaped
    ``[*lead, N]`` where `lead` is given (leading dimensions of M elements in all), else
    ``[M, N]``. On the card, K and N must be multiples of 8, x2's rows as `gemm_rows`
    returns them, w and the bias contiguous and 16-byte aligned, all on one device; else a
    ValueError."""
    rows = x2.shape[:1] if lead is None else tuple(lead)
    if not x2.is_cuda:
        return dense_reference(x2, w, bias).reshape(*rows, w.shape[0])
    m, k = x2.shape
    n = w.shape[0]
    device = x2.get_device()
    s0, s1 = x2.stride()
    if (x2.dtype != torch.bfloat16 or w.dtype != torch.bfloat16
            or bias.dtype != torch.float32 or k % 8 or n % 8 or w.shape[1] != k
            or bias.shape != (n,) or s1 != 1 or s0 % 8 or s0 < k
            or not (w.is_contiguous() and bias.is_contiguous())
            or (x2.data_ptr() | w.data_ptr() | bias.data_ptr()) % _ALIGN
            or w.get_device() != device or bias.get_device() != device):
        raise ValueError(
            f"the fused dense product takes bf16 x [M, K] (rows of unit stride, K, N and the "
            f"row stride multiples of 8) and w [N, K], an f32 bias [N], on one device, "
            f"16-byte aligned; got x {tuple(x2.shape)} {x2.dtype} stride {x2.stride()}, "
            f"w {tuple(w.shape)} {w.dtype}, bias {tuple(bias.shape)} {bias.dtype}")
    out = torch.empty((*rows, n), dtype=torch.bfloat16, device=x2.device)
    if m:
        _launch(_lib().r3m_dense_fwd, FORWARD, device, m, n, k, x2.data_ptr(), s0,
                w.data_ptr(), bias.data_ptr(), out.data_ptr())
        dense_fwd.launches += 1
    return out


dense_fwd.launches = 0


def dense_dx(g: torch.Tensor, w: torch.Tensor,
             lead: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``round_bf16(g @ w)`` for ``g [M, N]`` and ``w [N, K]``, both bf16: f32
    accumulation, one rounding; shaped ``[*lead, K]`` where `lead` is given, else
    ``[M, K]``. On the card both must be contiguous and 16-byte aligned, N and K multiples
    of 8, on one device; else a ValueError."""
    rows = g.shape[:1] if lead is None else tuple(lead)
    if not g.is_cuda:
        return dense_dx_reference(g, w).reshape(*rows, w.shape[1])
    m, n = g.shape
    k = w.shape[1]
    device = g.get_device()
    if (g.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or w.shape[0] != n
            or n % 8 or k % 8 or not (g.is_contiguous() and w.is_contiguous())
            or (g.data_ptr() | w.data_ptr()) % _ALIGN or w.get_device() != device):
        raise ValueError(
            f"the dense dx product takes contiguous, 16-byte aligned bf16 g [M, N] and "
            f"w [N, K] with N and K multiples of 8; got g {tuple(g.shape)} {g.dtype}, "
            f"w {tuple(w.shape)} {w.dtype}")
    dx = torch.empty((*rows, k), dtype=torch.bfloat16, device=g.device)
    if m:
        _launch(_lib().r3m_dense_dx, DX, device, m, n, k, g.data_ptr(), w.data_ptr(),
                dx.data_ptr())
        dense_dx.launches += 1
    return dx


dense_dx.launches = 0


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference between two tensors of bf16 values, in bf16 steps at the
    larger magnitude of each pair (2**(e - 8) for a magnitude in [2**(e-1), 2**e))."""
    got, want = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    step = torch.ldexp(torch.ones_like(got), e - 8)
    return ((got - want).abs() / step).max().item() if got.numel() else 0.0
