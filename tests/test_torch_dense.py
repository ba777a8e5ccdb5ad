"""`dense`'s bf16 route on the CPU: the fused route's Function and wrappers, whose products
compute their plain versions for CPU tensors and launch nothing, so bf16 on the CPU is the
unfused order bit for bit (the product with an f32 result, the f32 bias add, the cast
back). The fused Function's backward (dx from the bias-free product, dw from the
f32-result product, db as the f32 sum of the bf16 gradient) is held here to the JAX order
written in plain autograd. `gemm_rows`, which copies a view the products cannot read in
place, is plain PyTorch. The card's own tests are in ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import pytest
import torch

from r3m_tpu_torch.models import layers
from r3m_tpu_torch.ops.dense import (
    bf16_steps,
    dense_dx,
    dense_dx_reference,
    dense_fwd,
    dense_reference,
    gemm_rows,
)


def _operands(values, m=12, n=16, k=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    if values == "integers":  # every product and sum exact in f32
        ints = lambda *s: torch.randint(-3, 4, s, generator=g).float()  # noqa: E731
        return ints(m, k).bfloat16(), ints(n, k), ints(n) + 0.25, ints(m, n).bfloat16()
    return (torch.randn(m, k, generator=g).bfloat16(), torch.randn(n, k, generator=g),
            torch.randn(n, generator=g), torch.randn(m, n, generator=g).bfloat16())


@pytest.mark.parametrize("values", ["integers", "normal"])
def test_bf16_dense_on_the_cpu_is_the_unfused_order(values):
    x, w, b, _ = _operands(values)
    want = (torch.mm(x.float(), w.bfloat16().float().t()) + b).bfloat16()
    assert torch.equal(layers.dense(x, w, b), want)
    assert torch.equal(layers.dense(x.view(3, 4, -1), w, b), want.view(3, 4, -1))
    assert torch.equal(dense_fwd(x, w.bfloat16(), b), want)
    assert torch.equal(dense_reference(x, w.bfloat16(), b), want)


def test_the_fused_route_on_the_cpu_launches_nothing():
    """bf16 on the CPU runs the fused Function with its products' plain versions and
    launches nothing, also at a K the card's product would refuse."""
    x, w, b, g = _operands("normal")
    before = dense_fwd.launches, dense_dx.launches
    x_ = x.clone().requires_grad_(True)
    out = layers.dense(x_, w, b)
    assert type(out.grad_fn).__name__ == "_DenseFusedBackward"
    out.backward(g)
    odd = x[:, :12]
    want = (torch.mm(odd.float(), w[:, :12].bfloat16().float().t()) + b).bfloat16()
    assert torch.equal(layers.dense(odd, w[:, :12].contiguous(), b), want)
    assert (dense_fwd.launches, dense_dx.launches) == before


def test_gemm_rows_copies_only_what_the_products_cannot_read():
    tokens = torch.randn(6, 5, 16).bfloat16()
    cls = tokens[:, 0]  # rows 80 elements apart: read in place
    assert gemm_rows(cls) is cls
    rows = tokens.view(-1, 16)
    assert gemm_rows(rows) is rows
    flat = torch.randn(6 * 16 + 8).bfloat16()
    for view in (tokens.transpose(0, 1)[0].t(),  # columns of unit stride
                 tokens.view(-1, 4)[::3],  # a row stride of 12 elements, not 8's multiple
                 torch.randn(6, 20).bfloat16()[:, :16],  # a row stride of 20
                 flat[1:97].view(6, 16)):  # a start 2 bytes past alignment
        got = gemm_rows(view)
        assert got is not view and got.is_contiguous() and torch.equal(got, view)
        assert got.data_ptr() % 16 == 0


def test_dense_dx_on_the_cpu_rounds_the_f32_product_once():
    x, w, _, g = _operands("normal")
    want = torch.mm(g.float(), w.bfloat16().float()).bfloat16()
    assert torch.equal(dense_dx(g, w.bfloat16()), want)
    assert torch.equal(dense_dx_reference(g, w.bfloat16()), want)


def _grads(route, x, w, b, g):
    """dx, dw and db at (x, w, b) for the output gradient g, by `route`: the fused Function,
    or the JAX order in plain autograd, the bf16-cast weight an f32 leaf so that dw stays
    in f32."""
    x, b = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
    if route == "fused":
        w = w.clone().requires_grad_(True)
        out = layers._DenseFused.apply(x, w, b)
    else:
        w = w.bfloat16().float().requires_grad_(True)
        out = (x.float() @ w.t() + b).bfloat16()
    assert out.dtype == torch.bfloat16
    out.backward(g)
    return x.grad, w.grad, b.grad


@pytest.mark.parametrize("values", ["integers", "normal"])
def test_fused_function_gradients_are_the_unfused_orders(values):
    """Bit-equal on integers; on normal operands within one bf16 step, since db sums the
    same bf16 values in f32 in another order."""
    x, w, b, g = _operands(values)
    got = _grads("fused", x, w, b, g)
    want = _grads("jax", x, w, b, g)
    for a, e, dtype in zip(got, want, (torch.bfloat16, torch.float32, torch.float32)):
        assert a.dtype == e.dtype == dtype and a.shape == e.shape
        if values == "integers":
            assert torch.equal(a, e)
        else:
            assert bf16_steps(a, e) <= 1.0


def test_fused_function_keeps_the_leading_dimensions():
    """The Function flattens the rows inside: a [3, 4, K] input gives a [3, 4, N] output
    and a [3, 4, K] dx, the numbers of the flat call."""
    x, w, b, g = _operands("integers")
    flat = _grads("fused", x, w, b, g)
    x3 = x.view(3, 4, -1).clone().requires_grad_(True)
    w_, b_ = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    out = layers._DenseFused.apply(x3, w_, b_)
    assert out.shape == (3, 4, w.shape[0])
    out.backward(g.view(3, 4, -1))
    assert x3.grad.shape == x3.shape
    for a, e in zip((x3.grad.view(x.shape), w_.grad, b_.grad), flat):
        assert torch.equal(a, e)


def test_fused_function_backward_takes_a_strided_gradient():
    x, w, b, g = _operands("normal")
    wide = torch.cat([g, g], dim=1)[:, ::2]  # a gradient whose rows are not contiguous
    got = _grads("fused", x, w, b, wide)
    want = _grads("fused", x, w, b, wide.contiguous())
    assert all(torch.equal(a, e) for a, e in zip(got, want))


def test_bf16_steps_counts_steps_at_the_larger_magnitude():
    a = torch.tensor([256.0, 1.0, 0.0, -3.0]).bfloat16()
    b = torch.tensor([258.0, 1.0078125, 0.0, -3.0]).bfloat16()
    assert bf16_steps(a, b) == 1.0
    assert bf16_steps(a[2:], b[2:]) == 0.0
    assert bf16_steps(torch.tensor([255.0]), torch.tensor([256.0])) == 0.5
