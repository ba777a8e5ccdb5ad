"""LayerNorm and Dense for the ViT backbone, the port of ``r3m_tpu/models/layers.py``.

Statistics in f32 whatever the compute dtype; parameters live in f32: LayerNorm applies
them in f32, ``dense`` casts its weight to the activation dtype on use; products
accumulate in f32. Weights use torch's ``nn.Linear`` layout, ``[out, in]``.
"""

from __future__ import annotations

import torch

from r3m_tpu_torch.ops.dense import dense_dx, dense_fwd, gemm_rows
from r3m_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd, norm_rows
from r3m_tpu_torch.utils.profiling import DENSE_EPILOGUE, DENSE_FUSED, LAYER_NORM, span


class _LayerNorm(torch.autograd.Function):
    """LayerNorm of ``x [..., D]`` over its last axis with the f32 ``weight`` and ``bias``
    ``[D]`` (`r3m_tpu_torch.ops.layer_norm`): the rows are flattened inside, so that no view
    adds a node to the autograd graph, and only x's rows and each row's f32 mean and rstd
    are kept for the backward. The output gradient arrives in x's dtype; dx comes back in
    it, rounded once, dw and db in f32. For CPU tensors `layer_norm_fwd` and
    `layer_norm_bwd` compute their plain versions, and nothing is launched.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        x2 = norm_rows(x.reshape(-1, x.shape[-1]))
        y, mean, rstd = layer_norm_fwd(x2, weight, bias, eps, x.shape[:-1])
        ctx.save_for_backward(x2, mean, rstd, weight)
        ctx.lead = x.shape[:-1]
        return y

    @staticmethod
    def backward(ctx, g):
        x2, mean, rstd, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(g.reshape(-1, g.shape[-1]).contiguous(), x2, mean, rstd,
                                    weight)
        return (dx.reshape(*ctx.lead, dx.shape[-1]) if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None,
                db if ctx.needs_input_grad[2] else None, None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis as the JAX ``layer_norm`` computes it: f32 statistics
    (the mean, then the mean of the squared deviations), ``(x - mean) * rstd * weight +
    bias`` in f32 with the f32 parameters, one rounding to x.dtype.

    One route on every device, under the span ``r3m.layer_norm``: on the card one kernel a
    direction (`layer_norm_fwd` and `layer_norm_bwd` count their launches), on the CPU the
    same Function with the plain composition. A view whose rows the kernel cannot read in
    place is copied first (`norm_rows`); on the card a dtype other than f32 or bf16, or a D
    the kernel cannot hold, raises a ValueError. With a gradient to keep it runs as
    `_LayerNorm`, else as one `layer_norm_fwd` call.
    """
    with span(LAYER_NORM):
        if torch.is_grad_enabled() and (
                x.requires_grad or weight.requires_grad or bias.requires_grad):
            return _LayerNorm.apply(x, weight, bias, eps)
        return layer_norm_fwd(norm_rows(x.reshape(-1, x.shape[-1])), weight, bias, eps,
                              x.shape[:-1])[0]


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two low-precision matrices with an f32 result. On CUDA the f32 result
    comes straight from the GEMM (``out_dtype``); on the CPU, which lacks that overload,
    the operands are multiplied in f32, which is the same arithmetic."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


def _fused_operands(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor):
    """The fused product's operands: x's rows as the GEMM reads them (`gemm_rows`), the
    weight as a contiguous copy in x's dtype, the bias in f32."""
    return (gemm_rows(x.reshape(-1, x.shape[-1])),
            weight.to(x.dtype, memory_format=torch.contiguous_format),
            bias.to(torch.float32))


class _DenseFused(torch.autograd.Function):
    """``round(x @ weight.T + bias)`` for a bf16 ``x [..., K]``, the f32
    ``weight [N, K]`` cast to bf16 and the f32 ``bias [N]``, in one GEMM whose epilogue adds
    the bias to the f32 accumulator and rounds once (`r3m_tpu_torch.ops.dense`). The rows
    are flattened inside, so that no view adds a node to the autograd graph.

    The output gradient arrives in bf16. dx comes from the same GEMM without a bias (f32
    accumulation, one rounding), the weight's gradient in f32 from the f32-result GEMM, and
    the bias's as the f32 sum of the gradient's rows. For CPU tensors `dense_fwd` and
    `dense_dx` compute their plain versions, and nothing is launched.
    """

    @staticmethod
    def forward(ctx, x, weight, bias):
        x2, w, b = _fused_operands(x, weight, bias)
        ctx.save_for_backward(x2, w)
        ctx.lead = x.shape[:-1]
        return dense_fwd(x2, w, b, ctx.lead)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1]).contiguous()
        if g.data_ptr() % 16:
            g = g.clone()
        dx = dense_dx(g, w, ctx.lead) if ctx.needs_input_grad[0] else None
        dw = _mm_f32(g.t(), x2) if ctx.needs_input_grad[1] else None
        db = g.sum(dim=0, dtype=torch.float32) if ctx.needs_input_grad[2] else None
        return dx, dw, db


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x @ w.T + b as the JAX ``dense`` computes it: the product in x.dtype with an f32
    result, plus the f32 bias, and only then the rounding to x.dtype.

    In bf16 that order matters: rounding the product, or the bias, before the add gives
    other numbers. Differentiable in x, weight and bias. The dtype decides the route:

    - f32: the f32 product, then the bias (the span ``r3m.dense.epilogue``);
    - any other dtype: the fused route (the span ``r3m.dense.fused``). On the card the GEMM
      adds the bias and rounds once, `dense_fwd` counting its launches; on the CPU the same
      order runs as plain products. A view whose rows the GEMM cannot read in place is
      copied first (`gemm_rows`); on the card a dtype other than bf16, or K or N not a
      multiple of 8, raises a ValueError. With a gradient to keep it runs as
      `_DenseFused`, else as one `dense_fwd` call.
    """
    if x.dtype != torch.float32:
        with span(DENSE_FUSED):
            if torch.is_grad_enabled() and (
                    x.requires_grad or weight.requires_grad or bias.requires_grad):
                return _DenseFused.apply(x, weight, bias)
            return dense_fwd(*_fused_operands(x, weight, bias), x.shape[:-1])
    out = torch.matmul(x, weight.t())
    with span(DENSE_EPILOGUE):
        return (out + bias.to(torch.float32)).to(x.dtype)
