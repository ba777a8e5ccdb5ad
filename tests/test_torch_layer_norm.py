"""`layer_norm` on the CPU: the forward is the composition the port ran before its kernel,
bit for bit; the written-out backward matches autograd of the composition in f64; leading
dimensions and strided views are handled; nothing is launched; the span
``r3m.layer_norm`` opens once a call; only x's rows and each row's mean and rstd are kept
for the backward. The kernels themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import pytest
import torch

from r3m_tpu_torch.models.layers import layer_norm
from r3m_tpu_torch.ops.dense import bf16_steps
from r3m_tpu_torch.ops.layer_norm import (
    layer_norm_bwd,
    layer_norm_bwd_reference,
    layer_norm_fwd,
    layer_norm_reference,
    norm_rows,
)
from r3m_tpu_torch.utils import profiling

DTYPES = [torch.float32, torch.bfloat16]
# ViT-B/32's and DINOv2-g/14's widths, a width of odd size and the JAX parity test's 16
SHAPES = [(2, 5, 16), (3, 7, 768), (4, 1536), (6, 33)]


def _composition(x, weight, bias, eps, dtype=torch.float32):
    """The port's `layer_norm` before its kernel, with its statistics in `dtype`."""
    xf = x.to(dtype)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * weight.to(dtype) + bias.to(dtype)
    return y.to(x.dtype if dtype == torch.float32 else dtype)


def _inputs(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    d = shape[-1]
    x = (torch.randn(shape, generator=g) * 3 + 0.5).to(dtype)
    w = torch.randn(d, generator=g) * 0.5 + 1
    b = torch.randn(d, generator=g) * 0.1
    return x, w, b


@pytest.mark.parametrize("eps", [1e-12, 1e-6])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_is_the_composition_bit_for_bit(dtype, shape, eps):
    x, w, b = _inputs(shape, dtype)
    want = _composition(x, w, b, eps)
    with torch.no_grad():
        plain = layer_norm(x, w, b, eps)
    kept = layer_norm(x.clone().requires_grad_(True), w, b, eps)
    assert plain.dtype == dtype and plain.shape == x.shape
    assert torch.equal(plain, want) and torch.equal(kept, want)
    y, mean, rstd = layer_norm_reference(x.reshape(-1, shape[-1]), w, b, eps)
    assert torch.equal(y.reshape(shape), want)
    assert mean.dtype == rstd.dtype == torch.float32 and mean.shape == (y.shape[0],)


def _grads(x, w, b, eps, g, dtype):
    """dx, dw and db by autograd of the composition with its arithmetic in `dtype`."""
    x, w, b = (t.detach().to(dtype).requires_grad_(True) for t in (x, w, b))
    _composition(x, w, b, eps, dtype).backward(g.to(dtype))
    return x.grad, w.grad, b.grad


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_matches_autograd_of_the_composition_in_f64(dtype, shape):
    """dx, dw and db from the Function (the written-out backward on the CPU) against f64
    autograd of the composition on the same values: within f32 rounding of the largest
    term, and a bf16 dx within one bf16 step, but where dx is itself within f32 rounding of
    zero (there a bf16 step is finer than the f32 sums that make dx)."""
    x, w, b = _inputs(shape, dtype, seed=1)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(2)).to(dtype)
    xg, wg, bg = (t.clone().requires_grad_(True) for t in (x, w, b))
    layer_norm(xg, wg, bg, 1e-6).backward(g)
    got = (xg.grad, wg.grad, bg.grad)
    want = _grads(x, w, b, 1e-6, g, torch.float64)
    assert [t.dtype for t in got] == [dtype, torch.float32, torch.float32]
    for a, e in zip(got, want):
        assert a.shape == e.shape
    dx, dw, db = got
    dx64, dw64, db64 = want
    d = shape[-1]
    x2, g2 = x.reshape(-1, d).double(), g.reshape(-1, d).double()
    xhat = (x2 - x2.mean(-1, keepdim=True)) / x2.std(-1, unbiased=False, keepdim=True)
    term = (g2 * w.double()).abs().max() * (1 / x2.std(-1, unbiased=False)).max()
    f32 = 1e-5
    assert (dw.double() - dw64).abs().max() <= f32 * (g2 * xhat).abs().sum(0).max()
    assert (db.double() - db64).abs().max() <= f32 * g2.abs().sum(0).max()
    if dtype == torch.float32:
        assert (dx.double() - dx64).abs().max() <= f32 * term
    else:
        near_zero = dx64.abs() <= f32 * term
        assert bf16_steps(dx[~near_zero], dx64[~near_zero].float()) <= 1.0
        assert ((dx.double() - dx64)[near_zero].abs() <= 2 * f32 * term).all()


def test_leading_dimensions_are_kept():
    x, w, b = _inputs((2, 3, 5, 16), torch.bfloat16)
    xg = x.clone().requires_grad_(True)
    y = layer_norm(xg, w, b, 1e-12)
    assert y.shape == x.shape
    y.backward(torch.ones_like(y))
    assert xg.grad.shape == x.shape and xg.grad.dtype == torch.bfloat16
    with torch.inference_mode():
        assert layer_norm(x, w, b, 1e-12).shape == x.shape


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_strided_input_works(dtype):
    """ViT's class token row of each frame (rows of a longer stride, read in place) and a
    transposed view (copied first), forward and backward."""
    tokens, w, b = _inputs((4, 5, 64), dtype)
    cls = tokens[:, 0]
    assert norm_rows(cls) is cls
    transposed = tokens[:, :, :5].transpose(1, 2)  # [4, 5, 5], unit stride across rows
    rows = transposed[0]
    assert norm_rows(rows).is_contiguous() and not rows.is_contiguous()
    for view, (w_, b_) in ((cls, (w, b)), (transposed, (w[:5], b[:5]))):
        want = _composition(view.contiguous(), w_, b_, 1e-6)
        assert torch.equal(layer_norm(view, w_, b_, 1e-6), want)
        leaf = tokens.clone().requires_grad_(True)
        part = leaf[:, 0] if view is cls else leaf[:, :, :5].transpose(1, 2)
        layer_norm(part, w_, b_, 1e-6).sum().backward()
        plain = tokens.clone().requires_grad_(True)
        part = plain[:, 0] if view is cls else plain[:, :, :5].transpose(1, 2)
        layer_norm(part.contiguous(), w_, b_, 1e-6).sum().backward()
        assert torch.equal(leaf.grad, plain.grad)


def test_nothing_is_launched_on_the_cpu():
    x, w, b = _inputs((3, 7, 768), torch.bfloat16)
    before = (layer_norm_fwd.launches, layer_norm_bwd.launches)
    xg = x.clone().requires_grad_(True)
    layer_norm(xg, w, b, 1e-12).sum().backward()
    with torch.no_grad():
        layer_norm(x, w, b, 1e-12)
    y, mean, rstd = layer_norm_fwd(x.reshape(-1, 768), w, b, 1e-12)
    layer_norm_bwd(torch.ones_like(y), x.reshape(-1, 768), mean, rstd, w)
    assert (layer_norm_fwd.launches, layer_norm_bwd.launches) == before


def test_the_plain_backward_is_what_the_function_returns():
    x, w, b = _inputs((10, 48), torch.bfloat16, seed=3)
    g = torch.randn((10, 48), generator=torch.Generator().manual_seed(4)).bfloat16()
    xg, wg, bg = (t.clone().requires_grad_(True) for t in (x, w, b))
    layer_norm(xg, wg, bg, 1e-6).backward(g)
    _, mean, rstd = layer_norm_reference(x, w, b, 1e-6)
    dx, dw, db = layer_norm_bwd_reference(g, x, mean, rstd, w)
    assert torch.equal(xg.grad, dx) and torch.equal(wg.grad, dw) and torch.equal(bg.grad, db)


def test_only_the_rows_and_their_statistics_are_kept():
    """The Function keeps x's rows (x's own storage, no copy), the f32 mean and rstd of
    each row and the weight: no f32 copy of x and no xhat."""
    x, w, b = _inputs((3, 7, 64), torch.bfloat16)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = layer_norm(xg, wg, b, 1e-6)
    assert type(y.grad_fn).__name__ == "_LayerNormBackward"
    rows, mean, rstd, weight = y.grad_fn.saved_tensors
    assert rows.data_ptr() == xg.data_ptr() and rows.shape == (21, 64)
    assert rows.dtype == torch.bfloat16
    assert mean.shape == rstd.shape == (21,) and mean.dtype == rstd.dtype == torch.float32
    assert weight.data_ptr() == wg.data_ptr()
    with torch.no_grad():
        assert layer_norm(xg, wg, b, 1e-6).grad_fn is None


def test_the_span_opens_once_a_call():
    x, w, b = _inputs((3, 7, 32), torch.bfloat16)
    want = [layer_norm(x, w, b, 1e-6) for _ in range(3)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = [layer_norm(x, w, b, 1e-6) for _ in range(3)]
        xg = x.clone().requires_grad_(True)
        layer_norm(xg, w, b, 1e-6).sum().backward()
    names = [e.name for e in prof.events()]
    assert names.count(profiling.LAYER_NORM) == 4
    assert profiling.LAYER_NORM in profiling.SPANS
    assert all(torch.equal(a, c) for a, c in zip(want, got))
