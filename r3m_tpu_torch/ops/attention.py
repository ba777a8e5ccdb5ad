"""Kernels K3 and K4: fused multi-head self-attention over packed ``[B, T, H*D]``, forward
and backward.

Replaces the TPU kernel ``r3m_tpu/ops/attention.py`` (``_fwd_call`` and ``_bwd_call``
with their ``_kernel`` / ``_kernel_batched`` bodies, behind the custom-VJP
``fused_attention``), which the JAX ViT-B/32 forward runs in every layer. The Hopper
kernels are in ``r3m_tpu_torch/csrc/attention.cu``: one block per (batch, head) reads the
head's slices straight out of the packed tensors and is bound by memory. bfloat16 runs on
the tensor cores (``mma.sync``, T up to 128, D a multiple of 8 up to 128). float32 runs in
true f32 (``fmaf``, no TF32) on the CUDA cores, with a whole head and its T x T tiles in
shared memory and every product tiled in 4 x 4 register blocks read as float4, half a
shared-memory float per FMA; any D, and T as far as shared memory goes (at D = 64, T up to
156 forward and 124 backward). Both take 16-byte aligned tensors. The backward saves
nothing but q, k and v and recomputes P. The source says more.

Numerics, as in the TPU kernels: scores and softmax in f32, P cast to V's dtype before the
product with V (and, in the backward, before dV), dU cast to q's dtype before dQ and dK,
f32 accumulation, outputs in the input dtype. Float32 is true f32.

`fused_attention` is the differentiable entry point (`FusedAttentionFunction`). Its
forward goes through `fused_attention_fwd` (K3) and its backward through
`fused_attention_bwd` (K4). Each wrapper launches its kernel for CUDA tensors and counts
the launch in its ``launches`` attribute; for CPU tensors it computes its plain PyTorch
version, `fused_attention_reference` or `fused_attention_bwd_reference`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from r3m_tpu_torch.ops._build import load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
# The bf16 kernels: a warp per 16 query rows, at most 8 warps; rows of 16-byte chunks.
_BF16_MAX_T = 128
_BF16_MAX_D = 128
# The f32 kernels' longest head at D = 64, forward and backward, by their shared memory.
_F32_MAX_T_AT_64 = {False: 156, True: 124}


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Packed ``[B, T, H*D]`` -> ``[B, H, T, D]`` in f32."""
    b, t, hd = x.shape
    return x.reshape(b, t, n_heads, hd // n_heads).permute(0, 2, 1, 3).float()


def _packed(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``[B, H, T, D]`` -> packed ``[B, T, H*D]`` in `dtype`."""
    b, h, t, d = x.shape
    return x.to(dtype).permute(0, 2, 1, 3).reshape(b, t, h * d)


def _probs(qh: torch.Tensor, kh: torch.Tensor, d: int) -> torch.Tensor:
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    return e / e.sum(dim=-1, keepdim=True)


def fused_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int
) -> torch.Tensor:
    """Plain PyTorch softmax(Q K^T / sqrt(D)) V per head, packed ``[B, T, H*D]`` in/out."""
    d = q.shape[-1] // n_heads
    p = _probs(_heads(q, n_heads), _heads(k, n_heads), d)
    ctx = torch.matmul(p.to(v.dtype).float(), _heads(v, n_heads))
    return _packed(ctx, q.dtype)


def fused_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, n_heads: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch recompute-P backward: ``(dq, dk, dv)``, packed, in q's dtype.

    The arithmetic of the TPU kernel's ``_bwd_kernel_batched``: P recomputed in f32,
    dV = P~^T dO with P~ rounded to V's dtype, dP = dO V^T, dU = P o (dP - rowsum(dP o P))
    * scale rounded to q's dtype, dQ = dU K, dK = dU^T Q, every product summed in f32.
    """
    d = q.shape[-1] // n_heads
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh, doh = (_heads(x, n_heads) for x in (q, k, v, do))
    p = _probs(qh, kh, d)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    du = (p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale).to(q.dtype).float()
    dq = torch.matmul(du, kh)
    dk = torch.matmul(du.transpose(-1, -2), qh)
    return tuple(_packed(g, q.dtype) for g in (dq, dk, dv))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("attention")
    lib.r3m_attention_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.r3m_attention_fwd.restype = ctypes.c_int
    lib.r3m_attention_bwd.argtypes = [
        *([ctypes.c_void_p] * 7),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.r3m_attention_bwd.restype = ctypes.c_int
    for fn in (lib.r3m_attention_smem_bytes, lib.r3m_attention_bwd_smem_bytes):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_size_t
    return lib


def _check(name: str, n_heads: int, *xs: torch.Tensor) -> bool:
    """Validate packed operands; True for CPU tensors (the plain version), False for
    CUDA tensors the kernel takes. Raises on anything else."""
    q = xs[0]
    if q.ndim != 3 or any(x.shape != q.shape for x in xs):
        raise ValueError(
            f"{name}: operands must share one [B, T, H*D] shape, got "
            f"{[tuple(x.shape) for x in xs]}"
        )
    if q.shape[-1] % n_heads:
        raise ValueError(f"dim {q.shape[-1]} not divisible by n_heads={n_heads}")
    if all(x.device.type == "cpu" for x in xs):
        return True
    if any(x.device != q.device or x.device.type != "cuda" for x in xs):
        raise ValueError(
            f"{name} runs on one CUDA device or on the CPU, got {[str(x.device) for x in xs]}"
        )
    if q.dtype not in _DTYPES or any(x.dtype != q.dtype for x in xs):
        raise TypeError(
            f"{name} takes float32 or bfloat16 of one dtype, got {[x.dtype for x in xs]}"
        )
    if not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{name} needs contiguous packed tensors")
    return False


def _check_kernel_shape(lib, xs, t: int, d: int, backward: bool) -> None:
    """Raise for what the kernel of the operands' dtype does not take."""
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError("the attention kernels need 16-byte aligned tensors")
    if xs[0].dtype == torch.bfloat16:
        if t > _BF16_MAX_T or d % 8 or d > _BF16_MAX_D:
            raise ValueError(
                f"the bf16 kernel takes T up to {_BF16_MAX_T} and D a multiple of 8 up to "
                f"{_BF16_MAX_D}, got T={t}, D={d}"
            )
        return
    smem = (lib.r3m_attention_bwd_smem_bytes(t, d) if backward
            else lib.r3m_attention_smem_bytes(t, d))
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"T={t}, D={d} needs {smem} bytes of shared memory per block; the f32 kernels "
            f"keep a whole head on chip and take at most {_SMEM_LIMIT} (at D=64: T up to "
            f"{_F32_MAX_T_AT_64[backward]})"
        )


def fused_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int
) -> torch.Tensor:
    """K3: softmax(Q K^T / sqrt(D)) V per head over packed ``[B, T, n_heads * D]``.

    Head ``h`` occupies columns ``[h*D, (h+1)*D)``; the context comes back in the same
    packed layout. CUDA tensors must be contiguous float32 or bfloat16 of one shape and
    dtype, 16-byte aligned; they go through the Hopper kernel, never through the plain
    version. bfloat16 takes T up to 128 and D a multiple of 8 up to 128; float32 any D and
    what fits in shared memory (at D = 64, T up to 156; 124 for the backward).
    """
    if _check("fused_attention", n_heads, q, k, v):
        return fused_attention_reference(q, k, v, n_heads)
    b, t, hd = q.shape
    d = hd // n_heads
    lib = _lib()
    _check_kernel_shape(lib, (q, k, v), t, d, backward=False)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        err = lib.r3m_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, t, n_heads, d, 1.0 / math.sqrt(d), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_attention kernel launch failed: cudaError_t {err}")
    fused_attention_fwd.launches += 1
    return o


fused_attention_fwd.launches = 0


def fused_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, n_heads: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: ``(dq, dk, dv)`` of `fused_attention_fwd` at (q, k, v) for the output gradient
    `do`, all packed ``[B, T, n_heads * D]`` in q's dtype. CUDA tensors as for K3."""
    if _check("fused_attention_bwd", n_heads, q, k, v, do):
        return fused_attention_bwd_reference(q, k, v, do, n_heads)
    b, t, hd = q.shape
    d = hd // n_heads
    lib = _lib()
    _check_kernel_shape(lib, (q, k, v, do), t, d, backward=True)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    with torch.cuda.device(q.device):
        err = lib.r3m_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, t, n_heads, d, 1.0 / math.sqrt(d), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_attention_bwd kernel launch failed: cudaError_t {err}")
    fused_attention_bwd.launches += 1
    return dq, dk, dv


fused_attention_bwd.launches = 0


class FusedAttentionFunction(torch.autograd.Function):
    """K3 forward, K4 backward. Saves only q, k and v; the backward recomputes P."""

    @staticmethod
    def forward(ctx, q, k, v, n_heads):
        ctx.n_heads = n_heads
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v)
        return fused_attention_fwd(q, k, v, n_heads)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*fused_attention_bwd(q, k, v, do.contiguous(), ctx.n_heads), None)


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int
) -> torch.Tensor:
    """Softmax(Q K^T / sqrt(D)) V per head over packed ``[B, T, n_heads * D]`` tensors,
    differentiable in q, k and v (K3 forward, K4 backward on the card)."""
    return FusedAttentionFunction.apply(q, k, v, n_heads)
