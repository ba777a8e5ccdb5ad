"""LayerNorm and Dense for the ViT backbone, the port of ``r3m_tpu/models/layers.py``.

Statistics in f32 whatever the compute dtype; parameters live in f32 and are cast to the
activation dtype on use; products accumulate in f32. Weights use torch's ``nn.Linear``
layout, ``[out, in]``.
"""

from __future__ import annotations

import torch

from r3m_tpu_torch.utils.profiling import DENSE_EPILOGUE, span


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis; f32 statistics, output in x.dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * weight + bias
    return y.to(x.dtype)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two low-precision matrices with an f32 result. On CUDA the f32 result
    comes straight from the GEMM (``out_dtype``); on the CPU, which lacks that overload,
    the operands are multiplied in f32, which is the same arithmetic."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


class _DenseLowPrecision(torch.autograd.Function):
    """``x2 @ weight.T`` for a bf16 ``x2 [M, K]`` and an f32 ``weight [N, K]``: the
    weight is cast to x2's dtype, and the product has an f32 result.

    The backward computes both products the same way, with the f32 output gradient cast
    to x2's dtype first (it holds values of that dtype: the forward's output is cast down
    after the bias): dx comes back in x2's dtype, and the weight's gradient in f32 from
    the f32-result GEMM.
    """

    @staticmethod
    def forward(ctx, x2, weight):
        w = weight.to(x2.dtype)
        ctx.save_for_backward(x2, w)
        return _mm_f32(x2, w.t())

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = _mm_f32(g, w).to(x2.dtype) if ctx.needs_input_grad[0] else None
        dw = _mm_f32(g.t(), x2) if ctx.needs_input_grad[1] else None
        return dx, dw


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x @ w.T + b as the JAX ``dense`` computes it: the product in x.dtype with an f32
    result, plus the f32 bias, and only then the cast back to x.dtype.

    In bf16 that order matters: rounding the product before the bias add gives other
    numbers. Differentiable in x, weight and bias.
    """
    if x.dtype == torch.float32:
        out = torch.matmul(x, weight.t())
    else:
        x2 = x.reshape(-1, x.shape[-1])
        out = _DenseLowPrecision.apply(x2, weight)
        out = out.reshape(*x.shape[:-1], weight.shape[0])
    with span(DENSE_EPILOGUE):
        return (out + bias.to(torch.float32)).to(x.dtype)
