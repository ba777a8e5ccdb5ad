"""Kernel K3: fused multi-head self-attention forward over packed ``[B, T, H*D]``.

Replaces the forward of the TPU kernel ``r3m_tpu/ops/attention.py`` (``_fwd_call`` with
``_fwd_kernel`` / ``_fwd_kernel_batched``, public ``fused_attention``), which the JAX
ViT-B/32 serving forward runs in every layer. The Hopper kernel is
``r3m_tpu_torch/csrc/attention.cu``: one block per (batch, head) reads the head's slices
straight out of the packed tensors, keeps the T x T scores in shared memory, and is bound
by memory (read Q, K, V once, write O once). Its source says more.

Numerics, as in the TPU kernel: scores and softmax in f32, P cast to V's dtype before the
product with V, f32 accumulation, output in the input dtype. Float32 is true f32.

`fused_attention` launches the kernel for CUDA tensors and counts the launch in
``fused_attention.launches``; for CPU tensors it computes `fused_attention_reference`,
the plain PyTorch version of the same function.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from r3m_tpu_torch.ops._build import load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper


def fused_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int
) -> torch.Tensor:
    """Plain PyTorch softmax(Q K^T / sqrt(D)) V per head, packed ``[B, T, H*D]`` in/out."""
    b, t, hd = q.shape
    d = hd // n_heads

    def heads(x):
        return x.reshape(b, t, n_heads, d).permute(0, 2, 1, 3).float()

    qh, kh, vh = heads(q), heads(k), heads(v)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype).float()
    ctx = torch.matmul(p, vh).to(q.dtype)
    return ctx.permute(0, 2, 1, 3).reshape(b, t, hd)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("attention")
    lib.r3m_attention_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.r3m_attention_fwd.restype = ctypes.c_int
    lib.r3m_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.r3m_attention_smem_bytes.restype = ctypes.c_size_t
    return lib


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int
) -> torch.Tensor:
    """Softmax(Q K^T / sqrt(D)) V per head over packed ``[B, T, n_heads * D]`` tensors.

    Head ``h`` occupies columns ``[h*D, (h+1)*D)``; the context comes back in the same
    packed layout, ready for the output projection. CUDA tensors must be contiguous
    float32 or bfloat16 of one shape and dtype; they go through the Hopper kernel,
    never through the plain version.
    """
    if q.ndim != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one [B, T, H*D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, t, hd = q.shape
    if hd % n_heads:
        raise ValueError(f"dim {hd} not divisible by n_heads={n_heads}")
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return fused_attention_reference(q, k, v, n_heads)
    if any(x.device != q.device or x.device.type != "cuda" for x in (q, k, v)):
        raise ValueError(
            f"fused_attention runs on one CUDA device or on the CPU, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"fused_attention takes float32 or bfloat16 of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("fused_attention needs contiguous packed tensors")
    d = hd // n_heads
    lib = _lib()
    smem = lib.r3m_attention_smem_bytes(t, d)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"T={t}, D={d} needs {smem} bytes of shared memory per block; the kernel "
            f"keeps a whole head on chip and takes at most {_SMEM_LIMIT}"
        )
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
    fused_attention.launches += 1
    return o


fused_attention.launches = 0
