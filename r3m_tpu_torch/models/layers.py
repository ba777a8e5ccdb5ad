"""LayerNorm and Dense for the ViT backbone, the port of ``r3m_tpu/models/layers.py``.

Statistics in f32 whatever the compute dtype; parameters live in f32 and are cast to the
activation dtype on use; products accumulate in f32. Weights use torch's ``nn.Linear``
layout, ``[out, in]``.
"""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis; f32 statistics, output in x.dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * weight + bias
    return y.to(x.dtype)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x @ w.T + b as the JAX ``dense`` computes it: the product in x.dtype with an f32
    result, plus the f32 bias, and only then the cast back to x.dtype.

    In bf16 that order matters: rounding the product before the bias add gives other
    numbers. On CUDA the f32 result comes straight from the bf16 GEMM (``out_dtype``);
    on the CPU, which lacks that overload, the bf16 operands are multiplied in f32,
    which is the same arithmetic.
    """
    w = weight.to(x.dtype)
    if x.dtype == torch.float32:
        out = torch.matmul(x, w.t())
    else:
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda:
            out = torch.mm(x2, w.t(), out_dtype=torch.float32)
        else:
            out = torch.mm(x2.to(torch.float32), w.t().to(torch.float32))
        out = out.reshape(*x.shape[:-1], w.shape[0])
    return (out + bias.to(torch.float32)).to(x.dtype)
