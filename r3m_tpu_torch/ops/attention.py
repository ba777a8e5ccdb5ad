"""Kernels K3 and K4: fused multi-head self-attention over packed ``[B, T, H*D]``, forward
and backward.

Replaces the TPU kernel ``r3m_tpu/ops/attention.py`` (``_fwd_call`` and ``_bwd_call``
with their ``_kernel`` / ``_kernel_batched`` bodies, behind the custom-VJP
``fused_attention``), which the JAX ViT-B/32 forward runs in every layer. The Hopper
kernels are in ``r3m_tpu_torch/csrc/attention.cu``: they read each head's slices straight
out of the packed tensors. bfloat16 runs on the tensor cores (``mma.sync``, D a multiple of
8 up to 128). float32 runs in true f32 (``fmaf``, no TF32) on the CUDA cores, every product
tiled in 4 x 4 register blocks read as float4; it takes any D whose tiles fit in shared
memory. Both take any T, in one of three forms (`attention_fwd_path` and
`attention_bwd_path` say which a head takes; they agree at every shape):

- "block": one block keeps the whole head (T up to 128 in bf16; in f32 as long as the
  backward's T x T tiles fit, T up to 124 at D = 64);
- "head": one block a head past that, up to 176 tokens at D <= 64 (ViT-B/32 at 384 px:
  T = 145). In bf16 it walks its keys in chunks of 64 with the key-tiled kernels'
  arithmetic, so the result is theirs bit for bit. In f32 it keeps the head's K and V and
  walks the query rows in chunks of 32, each chunk's scores against every key taken once
  and softmaxed over the whole row, as the Pallas kernel does over its whole T x D block
  (the backward streams Q and dO a chunk at a time and keeps dK and dV in registers);
- "tiles": key-tiled blocks, with the softmax still exact (two passes over the keys: max
  and sum, then P); the backward is two kernels and a workspace.

Both take 16-byte aligned tensors. The backward saves nothing but q, k and v and recomputes
P, with the forward's arithmetic: K4's P is K3's bit for bit in every form. The source says
more.

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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``csrc/attention.cu``."""
    lib.r3m_attention_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.r3m_attention_fwd.restype = ctypes.c_int
    lib.r3m_attention_bwd.argtypes = [
        *([ctypes.c_void_p] * 8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.r3m_attention_bwd.restype = ctypes.c_int
    lib.r3m_attention_takes.argtypes = [ctypes.c_int] * 3
    lib.r3m_attention_takes.restype = ctypes.c_int
    lib.r3m_attention_bwd_workspace_bytes.argtypes = [ctypes.c_int] * 5
    lib.r3m_attention_bwd_workspace_bytes.restype = ctypes.c_size_t
    # an older attention.cu has fewer of these queries
    for query, n_args in (("r3m_attention_fwd_path", 3), ("r3m_attention_bwd_path", 3),
                          ("r3m_attention_head_blocks_per_sm", 4)):
        if hasattr(lib, query):
            getattr(lib, query).argtypes = [ctypes.c_int] * n_args
            getattr(lib, query).restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    return bind(load("attention"))


PATHS = {0: "block", 1: "head", 2: "tiles"}


def _path(query, t: int, d: int, dtype: torch.dtype) -> str:
    path = query(t, d, _DTYPES[dtype])
    if path not in PATHS:
        raise ValueError(f"the {dtype} attention kernels do not take T={t}, D={d}")
    return PATHS[path]


def attention_fwd_path(t: int, d: int, dtype: torch.dtype) -> str:
    """The form K3 takes for heads of `t` tokens and width `d` on the card: "block" (one
    block a head: T <= 128 in bf16, T <= 124 at D = 64 in f32), "head" (past that up to
    T = 176 at D <= 64: one block a head walking its keys, bf16, or its query rows, f32,
    in chunks) or "tiles" (key-tiled blocks). Builds the library; raises for what the
    kernels do not take."""
    return _path(_lib().r3m_attention_fwd_path, t, d, dtype)


def attention_head_blocks_per_sm(t: int, d: int, dtype: torch.dtype, backward: bool) -> int:
    """Blocks an SM of the "head" form's kernel of K3 (or K4, with `backward`) at `t`
    tokens and width `d`, from the occupancy calculator; -1 where the head takes another
    form. Needs the card."""
    return _lib().r3m_attention_head_blocks_per_sm(t, d, int(backward), _DTYPES[dtype])


def attention_bwd_path(t: int, d: int, dtype: torch.dtype) -> str:
    """The form K4 takes, named as `attention_fwd_path` names K3's; the same at every
    shape ("tiles" here is two key-tiled kernels and a workspace)."""
    return _path(_lib().r3m_attention_bwd_path, t, d, dtype)


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


def _check_kernel_shape(lib, xs, t: int, d: int) -> None:
    """Raise for what the kernel of the operands' dtype does not take."""
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError("the attention kernels need 16-byte aligned tensors")
    dtype = xs[0].dtype
    if not lib.r3m_attention_takes(t, d, _DTYPES[dtype]):
        what = ("D a multiple of 8 up to 128" if dtype == torch.bfloat16
                else "D whose key tiles fit in shared memory")
        raise ValueError(f"the {dtype} attention kernels take {what}, got T={t}, D={d}")


def fused_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int
) -> torch.Tensor:
    """K3: softmax(Q K^T / sqrt(D)) V per head over packed ``[B, T, n_heads * D]``.

    Head ``h`` occupies columns ``[h*D, (h+1)*D)``; the context comes back in the same
    packed layout. CUDA tensors must be contiguous float32 or bfloat16 of one shape and
    dtype, 16-byte aligned; they go through the Hopper kernel, never through the plain
    version. Any T; bfloat16 takes D a multiple of 8 up to 128, float32 any D whose tiles
    fit in shared memory.
    """
    if _check("fused_attention", n_heads, q, k, v):
        return fused_attention_reference(q, k, v, n_heads)
    b, t, hd = q.shape
    d = hd // n_heads
    lib = _lib()
    _check_kernel_shape(lib, (q, k, v), t, d)
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
    _check_kernel_shape(lib, (q, k, v, do), t, d)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    # m, l and delta of every row, when the head is done in key tiles
    work = lib.r3m_attention_bwd_workspace_bytes(b, t, n_heads, d, _DTYPES[q.dtype])
    work = torch.empty(work // 4, dtype=torch.float32, device=q.device) if work else None
    with torch.cuda.device(q.device):
        err = lib.r3m_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if work is None else work.data_ptr(),
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
