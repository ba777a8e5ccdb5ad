"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (Hopper, sm_90a) and the CUDA toolkit; without
them each test skips. This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from r3m_tpu_torch.models.distilbert import DistilBert, DistilBertConfig
from r3m_tpu_torch.models.r3m import R3MConfig, R3MEncoder, r3m_init
from r3m_tpu_torch.ops.attention import (
    _lib,
    attention_bwd_path,
    attention_fwd_path,
    attention_head_blocks_per_sm,
    fused_attention,
    fused_attention_bwd,
    fused_attention_bwd_reference,
    fused_attention_fwd,
    fused_attention_reference,
)
from r3m_tpu_torch.ops.pool import (
    maxpool_3x3s2,
    maxpool_3x3s2_bwd,
    maxpool_3x3s2_bwd_reference,
    maxpool_3x3s2_fwd,
    maxpool_3x3s2_reference,
)
from r3m_tpu_torch.training.trainer import create_train_state, make_train_step
from r3m_tpu_torch.training.workspace import Workspace
from tests.test_torch_relu_margin import assert_relu_margin, step_forward

pytestmark = pytest.mark.cuda

POOL_SHAPES = [(2, 112, 112, 64), (3, 7, 9, 5), (1, 1, 1, 3)]
# Where K1's strips of two outputs and K2's 2x2 owner blocks end: 40 stem images (more rows
# of blocks than the card holds at once), 80,000 output rows (more than one launch's grid
# takes, 65,535), odd and even H and W, and C on the 16-byte vector path (C * element size
# a multiple of 16) and on the narrow path.
POOL_EDGE_SHAPES = ([(40, 112, 112, 64), (40000, 3, 5, 8), (3, 9, 113, 64), (2, 18, 17, 8)]
                    + [(2, 9, 11, c) for c in (1, 3, 5, 8, 12, 64, 72, 128)])
ATTENTION_SHAPES = [(4, 50, 12, 64), (2, 10, 3, 8), (3, 7, 2, 16), (2, 120, 2, 64)]
# K4 keeps two T x T tiles of a head on chip, so it takes shorter heads than K3.
ATTENTION_BWD_SHAPES = [(4, 50, 12, 64), (2, 10, 3, 8), (3, 7, 2, 16), (2, 100, 2, 64)]
# K3/K4 sum in another order than their plain versions (which also round P and dU to
# bf16): f32 agrees to rounding, bf16 to a few bf16 steps of values of order 1.
ATTENTION_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# K3 and K4 round P (and K4 dU) to bf16 where their plain versions do, so only an element
# in a few thousand lands one rounding step apart: each output agrees to relative L2 error
# 5e-4. Without those roundings K4 would be ~3e-3 away.
ATTENTION_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 5e-4}
# The bf16 kernels' tiles end at multiples of 16 rows and of 16 columns of D: T at D=64
# and D at T=50 on either side of those edges, past the one-block limit T=128 (key tiles
# of 64 from there on, 128 where D > 64) and D up to 128. The backward keeps a head of
# 128 < T <= 176 at D <= 64 in one block: T on both sides of both its ends at D = 8, 64
# (in it) and 72, 128 (key tiles). 16 frames, so that the relative L2 error counts many
# rounding steps and not a handful.
EDGE_SHAPES = ([(16, t, 2, 64) for t in (1, 5, 15, 16, 17, 50, 64, 65, 127, 128, 129, 255, 256)]
               + [(16, 50, 2, d) for d in (8, 16, 32, 128)]
               + [(16, 145, 2, d) for d in (8, 72, 128)]
               + [(16, t, 2, d) for t in (128, 129, 176, 177) for d in (8, 72, 128)]
               + [(16, t, 2, 64) for t in (160, 161, 176, 177)])
# The f32 kernels' micro-tiles end at multiples of 4 rows and of 4 columns of D: T at D=64
# on either side of those edges and of the longest head one block keeps whole (124: from
# 125 to 176 forward and backward keep it in one block that walks the query rows in chunks
# of 32, the "head" form; ViT-B/32 at 384 px is T = 145), D at T=50 on either side of
# multiples of 4 and 8 (D % 4 != 0 takes the 4-byte load path), and D in key tiles (of up
# to 64 rows, 32 at D=128, 16 at D=256).
F32_EDGE_T = (1, 3, 4, 5, 7, 8, 9, 50, 63, 64, 65, 100, 124, 125, 145, 176)
F32_EDGE_D = [(16, 50, 2, d) for d in (4, 6, 12, 32, 128)] + [
    (8, 145, 2, d) for d in (6, 12, 128, 256)]
F32_EDGE_SHAPES = [(16, t, 2, 64) for t in (*F32_EDGE_T, 127, 128, 156, 157)] + F32_EDGE_D
F32_EDGE_BWD_SHAPES = [(16, t, 2, 64) for t in F32_EDGE_T] + F32_EDGE_D
# Heads longer than one block holds whole, in the head form or in key tiles: 384 px
# (T=145), 448 px (197), 512 px (257) and 768 px (577) ViTs among them; on both sides of
# the ends of the head forms (f32 from T = 125, both dtypes to T = 176 at D = 64) and at
# D = 8, 72 and 128.
LONG_SHAPES = ([(8, t, 2, 64) for t in (125, 129, 144, 145, 160, 170, 176, 177, 197, 257)]
               + [(8, t, 2, d) for t in (129, 176, 177) for d in (8, 72, 128)]
               + [(2, 577, 2, 64)])

@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels run only on CUDA tensors")
    return torch.Generator(device="cuda").manual_seed(0)


def _assert_close(got, want, dtype):
    assert got.dtype == dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    assert (got - want).abs().max().item() <= ATTENTION_ATOL[dtype]
    # relative L2 error, written so that an exact zero (dQ and dK at T=1) passes
    assert (got - want).norm().item() <= ATTENTION_REL_L2[dtype] * want.norm().item()


def _ties(gen, shape, dtype):
    """ReLU'd integers: most windows hold several equal maxima, as bf16 stem
    activations do."""
    return torch.randint(-2, 3, shape, generator=gen, device="cuda").clamp_min(0).to(dtype)


def _pool_input(gen, shape, dtype, values):
    return (torch.randn(shape, generator=gen, device="cuda").to(dtype) if values == "normal"
            else _ties(gen, shape, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("values", ["normal", "ties"])
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_pool_kernel_and_its_argmax_are_exact(gen, dtype, values, shape):
    x = _pool_input(gen, shape, dtype, values)
    before = maxpool_3x3s2_fwd.launches
    y, idx = maxpool_3x3s2_fwd(x, argmax=True)
    y_only, none = maxpool_3x3s2_fwd(x)
    torch.cuda.synchronize()
    assert maxpool_3x3s2_fwd.launches == before + 2
    want_y, want_idx = maxpool_3x3s2_reference(x)
    assert none is None and torch.equal(y_only, want_y)
    assert torch.equal(y, want_y) and torch.equal(idx, want_idx)


def test_pool_kernel_ties_and_nan(gen):
    x = _ties(gen, (2, 10, 10, 8), torch.float32)
    x[0, 3, 3, 1] = float("nan")
    (y, idx), (ref, ref_idx) = maxpool_3x3s2_fwd(x, argmax=True), maxpool_3x3s2_reference(x)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(y.cpu().numpy(), ref.cpu().numpy())
    assert torch.equal(idx, ref_idx)
    assert torch.isnan(y).sum().item() == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_pool_backward_kernel_is_exact(gen, dtype, shape):
    """K2 sums an element's contributions in window-offset order in f32, as its plain
    version does, so the two agree bit for bit."""
    _, idx = maxpool_3x3s2_reference(_ties(gen, shape, dtype))
    dy = torch.randn(idx.shape, generator=gen, device="cuda").to(dtype)
    before = maxpool_3x3s2_bwd.launches
    dx = maxpool_3x3s2_bwd(idx, dy, *shape[1:3])
    torch.cuda.synchronize()
    assert maxpool_3x3s2_bwd.launches == before + 1
    assert dx.dtype == dtype and tuple(dx.shape) == shape
    assert torch.equal(dx, maxpool_3x3s2_bwd_reference(idx, dy, *shape[1:3]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_gradient_goes_through_both_kernels(gen, dtype):
    x = _ties(gen, (2, 15, 12, 16), dtype).requires_grad_(True)
    fwd, bwd = maxpool_3x3s2_fwd.launches, maxpool_3x3s2_bwd.launches
    y = maxpool_3x3s2(x)
    assert y.grad_fn is not None
    dy = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (maxpool_3x3s2_fwd.launches, maxpool_3x3s2_bwd.launches) == (fwd + 1, bwd + 1)
    _, idx = maxpool_3x3s2_reference(x.detach())
    assert torch.equal(x.grad, maxpool_3x3s2_bwd_reference(idx, dy, 15, 12))


def _assert_pool_kernels_exact(gen, x, dy=None):
    """K1 with and without its argmax, then K2 on that argmax (with `dy`, or a fresh
    draw), against the plain versions; NaN where the plain version has NaN."""
    y, idx = maxpool_3x3s2_fwd(x, argmax=True)
    y_only, _ = maxpool_3x3s2_fwd(x)
    want_y, want_idx = maxpool_3x3s2_reference(x)
    if dy is None:
        dy = torch.randn(y.shape, generator=gen, device="cuda").to(x.dtype)
    dx = maxpool_3x3s2_bwd(idx, dy, *x.shape[1:3])
    torch.cuda.synchronize()
    for got in (y, y_only):
        np.testing.assert_array_equal(got.float().cpu().numpy(), want_y.float().cpu().numpy())
    assert torch.equal(idx, want_idx)
    want_dx = maxpool_3x3s2_bwd_reference(idx, dy, *x.shape[1:3])
    np.testing.assert_array_equal(dx.float().cpu().numpy(), want_dx.float().cpu().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("values", ["normal", "ties"])
@pytest.mark.parametrize("shape", POOL_EDGE_SHAPES)
def test_pool_kernels_at_their_edges_are_exact(gen, dtype, values, shape):
    _assert_pool_kernels_exact(gen, _pool_input(gen, shape, dtype, values))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [5, 64])
def test_pool_kernels_on_views_with_a_storage_offset(gen, dtype, c):
    """`x[1:]` is contiguous but starts 9*11*c elements in: 16-byte aligned at C=64 (the
    vector path), not at C=5 (the narrow path)."""
    x = _ties(gen, (3, 9, 11, c), dtype)[1:]
    dy = torch.randn((3, 5, 6, c), generator=gen, device="cuda").to(dtype)[1:]
    assert x.is_contiguous() and x.storage_offset() > 0 and dy.storage_offset() > 0
    _assert_pool_kernels_exact(gen, x, dy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 18, 17, 8), (3, 9, 113, 64), (2, 9, 11, 5)])
def test_pool_kernels_with_nan_in_first_last_and_shared_rows(gen, dtype, shape):
    """NaN in input row 0, in the last row, and in odd rows (2oy+1, which two output rows'
    windows share); in image 0, windows that hold only -inf, whose argmax is their first
    offset inside the input (4, 3, 1 and 0 for outputs (0,0), (0,1), (1,0), (1,1))."""
    x = _ties(gen, shape, dtype)
    h, w = shape[1:3]
    x[0, :4, :4] = float("-inf")
    for r in (0, 1, 3, h // 2 | 1, h - 1):
        x[:, r, (3 * r) % w, r % shape[3]] = float("nan")
    _assert_pool_kernels_exact(gen, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 4, 4, 8), (1, 5, 5, 8), (2, 9, 113, 64), (2, 6, 7, 5)])
def test_pool_backward_kernel_with_every_offset_everywhere(gen, dtype, shape):
    """K2 on an argmax drawn from 0..8 at random: every offset at every output, those that
    point into the padding and those whose input lies in an owner block's absent +1
    neighbour (last row and column at even H and W) included."""
    oh, ow = (shape[1] - 1) // 2 + 1, (shape[2] - 1) // 2 + 1
    idx = torch.randint(0, 9, (shape[0], oh, ow, shape[3]), generator=gen,
                        device="cuda").to(torch.int8)
    dy = torch.randn(idx.shape, generator=gen, device="cuda").to(dtype)
    dx = maxpool_3x3s2_bwd(idx, dy, *shape[1:3])
    torch.cuda.synchronize()
    assert torch.equal(dx, maxpool_3x3s2_bwd_reference(idx, dy, *shape[1:3]))


def test_pool_kernel_rejects_what_it_does_not_take(gen):
    x = torch.randn((2, 8, 8, 4), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        maxpool_3x3s2(x.permute(0, 2, 1, 3))
    with pytest.raises(TypeError, match="bfloat16"):
        maxpool_3x3s2(x.half())
    _, idx = maxpool_3x3s2_fwd(x, argmax=True)
    with pytest.raises(TypeError, match="int8"):
        maxpool_3x3s2_bwd(idx.int(), torch.zeros_like(idx, dtype=torch.float32), 8, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,d", ATTENTION_SHAPES)
def test_attention_kernel_matches_plain_version(gen, dtype, b, t, h, d):
    q, k, v = (torch.randn((b, t, h * d), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    before = fused_attention_fwd.launches
    o = fused_attention(q, k, v, h)
    torch.cuda.synchronize()
    assert fused_attention_fwd.launches == before + 1
    _assert_close(o, fused_attention_reference(q, k, v, h), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,d", ATTENTION_BWD_SHAPES)
def test_attention_backward_kernel_matches_plain_version(gen, dtype, b, t, h, d):
    q, k, v, do = (torch.randn((b, t, h * d), generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    before = fused_attention_bwd.launches
    got = fused_attention_bwd(q, k, v, do, h)
    torch.cuda.synchronize()
    assert fused_attention_bwd.launches == before + 1
    for g, want in zip(got, fused_attention_bwd_reference(q, k, v, do, h)):
        _assert_close(g, want, dtype)


@pytest.mark.parametrize("b,t,h,d", EDGE_SHAPES)
def test_bf16_attention_kernel_at_tile_edges(gen, b, t, h, d):
    q, k, v = (torch.randn((b, t, h * d), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    o = fused_attention_fwd(q, k, v, h)
    torch.cuda.synchronize()
    _assert_close(o, fused_attention_reference(q, k, v, h), torch.bfloat16)


@pytest.mark.parametrize("b,t,h,d", EDGE_SHAPES)
def test_bf16_attention_backward_kernel_at_tile_edges(gen, b, t, h, d):
    q, k, v, do = (torch.randn((b, t, h * d), generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    got = fused_attention_bwd(q, k, v, do, h)
    torch.cuda.synchronize()
    for g, want in zip(got, fused_attention_bwd_reference(q, k, v, do, h)):
        _assert_close(g, want, torch.bfloat16)


@pytest.mark.parametrize("b,t,h,d", F32_EDGE_SHAPES)
def test_f32_attention_kernel_at_tile_edges(gen, b, t, h, d):
    q, k, v = (torch.randn((b, t, h * d), generator=gen, device="cuda") for _ in range(3))
    o = fused_attention_fwd(q, k, v, h)
    torch.cuda.synchronize()
    _assert_close(o, fused_attention_reference(q, k, v, h), torch.float32)


@pytest.mark.parametrize("b,t,h,d", F32_EDGE_BWD_SHAPES)
def test_f32_attention_backward_kernel_at_tile_edges(gen, b, t, h, d):
    q, k, v, do = (torch.randn((b, t, h * d), generator=gen, device="cuda") for _ in range(4))
    got = fused_attention_bwd(q, k, v, do, h)
    torch.cuda.synchronize()
    for g, want in zip(got, fused_attention_bwd_reference(q, k, v, do, h)):
        _assert_close(g, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,d", LONG_SHAPES)
def test_attention_kernels_take_long_heads(gen, dtype, b, t, h, d):
    """K3 and K4 past one whole block (the head form or key tiles) against their plain
    versions, K4 also against autograd of K3's plain forward, and K4 the same from run to
    run (no atomics)."""
    q, k, v, do = (torch.randn((b, t, h * d), generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    fwd, bwd = fused_attention_fwd.launches, fused_attention_bwd.launches
    o = fused_attention_fwd(q, k, v, h)
    got = fused_attention_bwd(q, k, v, do, h)
    again = fused_attention_bwd(q, k, v, do, h)
    torch.cuda.synchronize()
    assert (fused_attention_fwd.launches, fused_attention_bwd.launches) == (fwd + 1, bwd + 2)
    _assert_close(o, fused_attention_reference(q, k, v, h), dtype)
    for g, a, want in zip(got, again, fused_attention_bwd_reference(q, k, v, do, h)):
        _assert_close(g, want, dtype)
        assert torch.equal(g, a)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    auto = torch.autograd.grad(fused_attention_reference(*leaves, h), leaves, do)
    atol = {torch.float32: 1e-5, torch.bfloat16: 6e-2}[dtype]
    for g, a in zip(got, auto):
        assert (g.float() - a.float()).abs().max().item() <= atol


def test_bf16_attention_backward_gives_the_same_bits_twice(gen):
    """K4 at ViT-B/32's 384 px head (one block a head walking its keys) has one owner
    for every output element and no atomics: two launches give the same bits."""
    q, k, v, do = (torch.randn((8, 145, 2 * 64), generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    first = fused_attention_bwd(q, k, v, do, 2)
    second = fused_attention_bwd(q, k, v, do, 2)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_f32_attention_gives_the_same_bits_twice(gen):
    """K3 and K4 in f32 at ViT-B/32's 384 px head (one block a head walking its query rows
    in chunks) have one owner for every output element and no atomics: two launches give
    the same bits."""
    assert attention_fwd_path(145, 64, torch.float32) == "head"
    q, k, v, do = (torch.randn((8, 145, 2 * 64), generator=gen, device="cuda")
                   for _ in range(4))
    first = (fused_attention_fwd(q, k, v, 2), *fused_attention_bwd(q, k, v, do, 2))
    second = (fused_attention_fwd(q, k, v, 2), *fused_attention_bwd(q, k, v, do, 2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_head_kernels_keep_their_blocks_an_sm(gen, dtype):
    """At ViT-B/32's 384 px head the head form's K3 fits two blocks an SM and K4 one (its
    K and V, and in bf16 Q and dO too, fill most of the shared memory); a head of another
    form has no head kernel to ask about."""
    assert attention_head_blocks_per_sm(145, 64, dtype, backward=False) == 2
    assert attention_head_blocks_per_sm(145, 64, dtype, backward=True) == 1
    assert attention_head_blocks_per_sm(50, 64, dtype, backward=True) == -1


def test_bf16_attention_forward_gives_the_same_bits_twice(gen):
    """K3 at ViT-B/32's 384 px head (one block a head walking its keys) has one owner for
    every output element: two launches give the same bits."""
    assert attention_fwd_path(145, 64, torch.bfloat16) == "head"
    q, k, v = (torch.randn((8, 145, 2 * 64), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    first = fused_attention_fwd(q, k, v, 2)
    second = fused_attention_fwd(q, k, v, 2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype,t,path", [
    (torch.bfloat16, 50, "block"), (torch.bfloat16, 145, "head"), (torch.bfloat16, 177, "tiles"),
    (torch.float32, 145, "head")])
def test_attention_forward_and_backward_share_rounded_probabilities(gen, dtype, t, path):
    """K4 recomputes P and rounds it to V's dtype (P~; in f32 P itself) for dV; it must
    be K3's P~ bit for bit, in each form. With V one-hot over a block of 64 keys
    (V[j, c] = 1 where j = c + 64 blk, every head), K3's output is exactly that block of
    P~: one term summed in f32 (and rounded back to bf16). With dO one-hot the same way
    over query rows, K4's dV is exactly that block of P~^T. The two assemble the whole P~
    of every head."""
    b, h, d = 2, 2, 64
    assert attention_fwd_path(t, d, dtype) == path
    assert attention_bwd_path(t, d, dtype) == path
    q, k, v = (torch.randn((b, t, h * d), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    p_fwd, p_bwd = (torch.full((b, t, h, t), float("nan"), device="cuda", dtype=dtype)
                    for _ in range(2))  # [b, query, h, key]
    for j0 in range(0, t, d):
        n = min(d, t - j0)
        onehot = torch.zeros((t, d), device="cuda", dtype=dtype)
        onehot[j0 + torch.arange(n), torch.arange(n)] = 1
        onehot = onehot.repeat(1, h).expand(b, t, h * d).contiguous()
        o = fused_attention_fwd(q, k, onehot, h).view(b, t, h, d)
        p_fwd[..., j0:j0 + n] = o[..., :n]  # o[., i, ., c] = P~[i, j0 + c]
        dv = fused_attention_bwd(q, k, v, onehot, h)[2].view(b, t, h, d)
        p_bwd[:, j0:j0 + n] = dv[..., :n].permute(0, 3, 2, 1)  # dv[., j, ., c] = P~[j0 + c, j]
    torch.cuda.synchronize()
    assert not p_fwd.isnan().any()
    assert torch.equal(p_fwd, p_bwd)


PATH_CASES = [
    (50, 64, torch.bfloat16, "block"), (128, 64, torch.bfloat16, "block"),
    (129, 64, torch.bfloat16, "head"), (145, 64, torch.bfloat16, "head"),
    (176, 64, torch.bfloat16, "head"), (176, 8, torch.bfloat16, "head"),
    (177, 64, torch.bfloat16, "tiles"), (145, 72, torch.bfloat16, "tiles"),
    (145, 128, torch.bfloat16, "tiles"), (577, 64, torch.bfloat16, "tiles"),
    (50, 64, torch.float32, "block"), (124, 64, torch.float32, "block"),
    (125, 64, torch.float32, "head"), (145, 64, torch.float32, "head"),
    (176, 64, torch.float32, "head"), (177, 64, torch.float32, "tiles"),
    (145, 72, torch.float32, "tiles"),
]


@pytest.mark.parametrize("t,d,dtype,path", PATH_CASES)
def test_attention_forward_takes_the_path_of_the_backward(gen, t, d, dtype, path):
    """K3 takes the same form as K4 at every shape, so that K4's recomputed P is K3's
    (the test above holds them to that bit for bit)."""
    assert attention_fwd_path(t, d, dtype) == attention_bwd_path(t, d, dtype) == path


@pytest.mark.parametrize("t,d,dtype,path", PATH_CASES)
def test_attention_backward_takes_the_path_its_boundary_says(gen, t, d, dtype, path):
    """The bf16 backward keeps a head in one block up to T = 128, and up to 176 at
    D <= 64 walking its keys in chunks; the f32 backward keeps it whole up to T = 124 at
    D = 64, and up to 176 at D <= 64 walking its query rows in chunks; past that both go
    in key tiles, the only form that needs a workspace."""
    assert attention_bwd_path(t, d, dtype) == path
    work = _lib().r3m_attention_bwd_workspace_bytes(2, t, 3, d, 1 if dtype == torch.bfloat16
                                                    else 0)
    assert work == (4 * 3 * 2 * 3 * t if path == "tiles" else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [17, 50, 64, 145])
def test_attention_kernels_stay_inside_their_frame(gen, dtype, t):
    """Odd frames hold +-100 in Q, K, V and dO, and packed row T of an even frame is row 0
    of the odd frame after it: a kernel that read or softmaxed past row T would get the
    even frames wrong. They are held to the plain versions on the even frames alone."""
    h, d = 2, 64
    xs = [torch.randn((16, t, h * d), generator=gen, device="cuda") for _ in range(4)]
    for x in xs:
        x[1::2] = torch.randn(x[1::2].shape, generator=gen, device="cuda").sign() * 100.0
    q, k, v, do = (x.to(dtype) for x in xs)
    o = fused_attention_fwd(q, k, v, h)
    grads = fused_attention_bwd(q, k, v, do, h)
    torch.cuda.synchronize()
    even = [x[::2].contiguous() for x in (q, k, v, do)]
    _assert_close(o[::2], fused_attention_reference(*even[:3], h), dtype)
    for g, w in zip(grads, fused_attention_bwd_reference(*even, h)):
        _assert_close(g[::2], w, dtype)
    assert all(torch.isfinite(x).all() for x in (o, *grads))


def test_attention_gradient_goes_through_both_kernels(gen):
    """Under grad, a CUDA call carries a grad_fn and its backward is K4; in f32 that is
    the gradient of the plain forward."""
    q, k, v = (torch.randn((3, 50, 128), generator=gen, device="cuda").requires_grad_(True)
               for _ in range(3))
    fwd, bwd = fused_attention_fwd.launches, fused_attention_bwd.launches
    o = fused_attention(q, k, v, 2)
    assert o.grad_fn is not None
    do = torch.randn(o.shape, generator=gen, device="cuda")
    grads = torch.autograd.grad(o, (q, k, v), do)
    assert (fused_attention_fwd.launches, fused_attention_bwd.launches) == (fwd + 1, bwd + 1)
    want = torch.autograd.grad(fused_attention_reference(q, k, v, 2), (q, k, v), do)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_attention_kernel_rejects_a_head_too_long_for_shared_memory(gen):
    """No head is too long now: f32 past what one block's shared memory holds whole
    (T=125 and 157 at D=64: the head form) and bf16 past its one-block tiles (T=129) go in
    a head form or key tiles. What the kernels still refuse: bf16 D not a multiple of 8 or above 128, f32 D
    whose tiles do not fit, and tensors that are not 16-byte aligned."""
    for t, dtype in ((157, torch.float32), (125, torch.float32), (129, torch.bfloat16)):
        q = torch.randn((1, t, 64), generator=gen, device="cuda").to(dtype)
        assert fused_attention(q, q, q, 1).shape == q.shape
        assert all(g.shape == q.shape for g in fused_attention_bwd(q, q, q, q, 1))
    q = torch.randn(50 * 64 + 1, generator=gen, device="cuda")[1:].view(1, 50, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_attention(q, q, q, 1)
    with pytest.raises(ValueError, match="tiles fit in shared memory"):
        q = torch.randn((1, 50, 1024), generator=gen, device="cuda")
        fused_attention(q, q, q, 1)
    for shape in ((1, 129, 12), (1, 50, 12), (1, 50, 136)):
        q = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        with pytest.raises(ValueError, match="D a multiple of 8 up to 128"):
            fused_attention(q, q, q, 1)
        with pytest.raises(ValueError, match="D a multiple of 8 up to 128"):
            fused_attention_bwd(q, q, q, q, 1)
    q = torch.randn(50 * 64 + 1, generator=gen, device="cuda").bfloat16()[1:].view(1, 50, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_attention(q, q, q, 1)


@pytest.mark.parametrize("size", [18, 0])
def test_encoder_on_the_card_matches_the_cpu(gen, size):
    cfg = R3MConfig(size=size, image_size=64)
    torch.manual_seed(0)
    cpu = R3MEncoder(cfg, device="cpu")
    cuda = R3MEncoder(cfg, cpu.convnet.state_dict())
    obs = np.random.default_rng(0).integers(0, 256, (2, 3, 48, 80), dtype=np.uint8)
    got, want = cuda(obs).cpu(), cpu(obs)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("size,image_size", [(18, 32), (0, 64)])
def test_every_parameter_gets_a_gradient_on_the_card(gen, size, image_size):
    """One bf16 train step on the card: every trainable parameter, those before the stem
    pool and every Q/K/V projection included, has a finite, non-zero gradient, and the
    step went through the kernels of its backbone."""
    cfg = R3MConfig(size=size, hidden_dim=64, langweight=1.0, image_size=image_size,
                    compute_dtype="bfloat16")
    torch.manual_seed(0)
    bert = DistilBert(DistilBertConfig(vocab_size=100, n_layers=1, n_heads=4,
                                       hidden_dim=128, max_position_embeddings=16))
    state = create_train_state(cfg, 0)
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (4, 5, image_size, image_size, 3), np.uint8),
             "token_ids": rng.integers(0, 100, (4, 12)),
             "attn_mask": np.ones((4, 12), np.int64), "lang_mask": np.ones(4, np.float32)}
    counters = (maxpool_3x3s2_fwd, maxpool_3x3s2_bwd, fused_attention_fwd, fused_attention_bwd)
    before = [c.launches for c in counters]
    state, metrics = make_train_step(cfg, bert, doaug="rctraj")(state, batch)
    assert torch.isfinite(metrics["full_loss"]).item()
    launched = [c.launches - b for c, b in zip(counters, before)]
    assert launched == ([1, 1, 0, 0] if size else [0, 0, 12, 12])
    for name, p in state.model.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all() and (p.grad != 0).any(), name


REWARD_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "pick", "up", "the", "cup", "open",
                "door", "drawer"]
REWARD_SENTENCES = ["pick up the cup", "open the door", "open the drawer slowly"]
# Card against CPU in parity: the same f32 reward up to the order of f32 sums in the
# encoder; fast (bf16 encoder) against parity: the bf16 embedding's rounding.
REWARD_ATOL = {"parity": 1e-4, "fast": 5e-2}


def _reward_artifacts(tmp_path, size, image_size):
    """A small port train snapshot with its reward head, a 2-layer DistilBERT of 4 heads
    written with ``bert_config`` metadata, and a vocab, from fixed seeds."""
    import dataclasses

    from r3m_tpu_torch.checkpoint import save_snapshot, save_train_snapshot
    from r3m_tpu_torch.convert import distilbert_tree

    cfg = R3MConfig(size=size, hidden_dim=32, langweight=1.0, lang_dim=64,
                    image_size=image_size)
    snap = save_train_snapshot(str(tmp_path), create_train_state(cfg, 0, device="cpu"), cfg)
    torch.manual_seed(0)
    bert = DistilBert(DistilBertConfig(vocab_size=len(REWARD_VOCAB), dim=64, n_layers=2,
                                       n_heads=4, hidden_dim=96, max_position_embeddings=40))
    bert_path = str(tmp_path / "distilbert.npz")
    save_snapshot(bert_path, distilbert_tree(bert.state_dict()),
                  {"bert_config": dataclasses.asdict(bert.cfg)})
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(REWARD_VOCAB) + "\n")
    return snap, bert_path, str(vocab)


@pytest.mark.parametrize("precision", ["parity", "fast"])
@pytest.mark.parametrize("size,image_size", [(18, 32), (0, 64)])
def test_reward_on_the_card_matches_the_cpu(gen, tmp_path, size, image_size, precision):
    """Rewards of image pairs and a reward curve on the card, through K1 (one stacked pass
    a query) or K3 (12 launches a pass), against the port on the CPU."""
    from r3m_tpu_torch.reward import R3MRewardModel

    arts = _reward_artifacts(tmp_path, size, image_size)
    cuda = R3MRewardModel.from_snapshot(*arts, precision=precision)
    cpu = R3MRewardModel.from_snapshot(*arts, device="cpu")
    rng = np.random.default_rng(0)
    im0, imt = (rng.integers(0, 256, (3, 3, image_size, image_size), np.uint8)
                for _ in range(2))
    counter, per_pass = ((maxpool_3x3s2_fwd, 1) if size else (fused_attention_fwd, 12))
    before = counter.launches
    got = cuda(im0, imt, REWARD_SENTENCES)
    curve = cuda.reward_curve(np.concatenate([im0, imt]), "open the door")
    torch.cuda.synchronize()
    assert counter.launches == before + 2 * per_pass
    assert got.device.type == "cuda" and got.dtype == torch.float32 and got.shape == (3,)
    want = cpu(im0, imt, REWARD_SENTENCES)
    want_curve = cpu.reward_curve(np.concatenate([im0, imt]), "open the door")
    atol = REWARD_ATOL[precision]
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=atol)
    torch.testing.assert_close(curve.cpu(), want_curve, rtol=0, atol=atol)


def test_reward_does_not_move_with_the_callers_tf32_flags(gen, tmp_path):
    """DistilBERT and the reward MLP run in true f32 on the card whatever the caller
    allows: the rewards with TF32 allowed equal those with it off."""
    from r3m_tpu_torch.reward import R3MRewardModel

    rm = R3MRewardModel.from_snapshot(*_reward_artifacts(tmp_path, 18, 32))
    rng = np.random.default_rng(1)
    e0, es = (rng.standard_normal((3, 512)).astype(np.float32) for _ in range(2))
    saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    out = {}
    try:
        for allow, matmul in ((False, "highest"), (True, "medium")):
            torch.backends.cudnn.allow_tf32 = allow
            torch.set_float32_matmul_precision(matmul)
            out[allow] = rm.get_reward(e0, es, REWARD_SENTENCES).cpu()
            assert (torch.backends.cudnn.allow_tf32,
                    torch.get_float32_matmul_precision()) == (allow, matmul)
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    torch.testing.assert_close(out[True], out[False], rtol=1e-6, atol=0)


def test_embed_cli_on_the_card_matches_the_cpu(gen, tmp_path):
    """Seven PNG files in batches of 3 (two full and a padded tail of one): three K1
    launches, the same paths and embeddings as ``--device cpu``."""
    image = pytest.importorskip("PIL.Image")
    from r3m_tpu_torch import embed
    from r3m_tpu_torch.models.resnet import ResNet

    torch.manual_seed(0)
    pt = str(tmp_path / "model.pt")
    torch.save({"r3m": {f"module.convnet.{k}": v for k, v in ResNet(18).state_dict().items()}},
               pt)
    rng = np.random.default_rng(0)
    for i in range(7):
        image.fromarray(rng.integers(0, 256, (240, 300, 3), np.uint8)).save(
            tmp_path / f"f{i}.png")
    args = [str(tmp_path), "--model-file", pt, "--batch", "3"]
    before = maxpool_3x3s2_fwd.launches
    got = np.load(embed.main(args + ["--out", str(tmp_path / "cuda.npz")]))
    assert maxpool_3x3s2_fwd.launches == before + 3
    want = np.load(embed.main(args + ["--out", str(tmp_path / "cpu.npz"), "--device", "cpu"]))
    assert list(got["paths"]) == list(want["paths"]) and got["embeddings"].shape == (7, 512)
    np.testing.assert_allclose(got["embeddings"], want["embeddings"], rtol=1e-3, atol=1e-3)


def _small_f32_step_inputs(batch_seed=1):
    """A ResNet-18 at 32 px with a language head, a small frozen DistilBERT, a batch, its
    permutations and crops, all from fixed seeds."""
    cfg = R3MConfig(size=18, hidden_dim=64, langweight=1.0, image_size=32)
    torch.manual_seed(0)
    bert = DistilBert(DistilBertConfig(vocab_size=100, n_layers=1, n_heads=4,
                                       hidden_dim=128, max_position_embeddings=16))
    model = r3m_init(cfg, 0)
    rng = np.random.default_rng(batch_seed)
    batch = {"images": rng.integers(0, 256, (4, 5, 40, 48, 3), np.uint8),
             "token_ids": rng.integers(0, 100, (4, 12)),
             "attn_mask": np.ones((4, 12), np.int64), "lang_mask": np.ones(4, np.float32)}
    perms = {"lang": torch.stack([torch.randperm(4) for _ in range(9)]).reshape(3, 3, 4),
             "tcn": torch.stack([torch.randperm(4) for _ in range(6)]).reshape(3, 2, 4)}
    crops = torch.tensor([[0, 0, 40, 48], [3, 5, 30, 33], [10, 2, 21, 25], [1, 9, 38, 39]],
                         dtype=torch.float32)
    return cfg, bert, model, batch, perms, crops


class _Placer:
    """The workspace's device placement (pinned side-stream copies) on the current card."""

    _place = Workspace._place
    _ready = Workspace._ready
    _device_prefetch = Workspace._device_prefetch

    def __init__(self):
        self.device = torch.device("cuda", torch.cuda.current_device())
        self._copy_stream = torch.cuda.Stream(self.device)


def _host_batch(rng):
    return {"images": rng.integers(0, 256, (4, 5, 64, 64, 3), dtype=np.uint8),
            "token_ids": rng.integers(0, 30, (4, 8)).astype(np.int32),
            "attn_mask": np.ones((4, 8), np.int32),
            "lang_mask": np.array([1, 0, 1, 1], np.float32), "captions": ["a", "", "b", "c"]}


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_places_what_a_plain_copy_places(gen, depth):
    """Batches pinned and copied on the side stream by the producer thread (depth 2) or
    in the caller's (depth 0) equal a plain ``.to()`` of the same arrays, dtype for dtype;
    the captions stay on the host."""
    rng = np.random.default_rng(0)
    batches = [_host_batch(rng) for _ in range(5)]
    p = _Placer()
    got = [p._ready(item) for item in p._device_prefetch(iter(batches), depth=depth)]
    torch.cuda.synchronize()
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        assert set(g) == set(b) - {"captions"}
        for k, t in g.items():
            want = torch.from_numpy(b[k]).to("cuda")
            assert t.device.type == "cuda" and t.dtype == want.dtype, k
            assert torch.equal(t, want), k


@pytest.mark.parametrize("clips,hw", [(4, 64), (64, 224)])
def test_a_placed_batch_outlives_the_step_that_reads_it(gen, clips, hw):
    """A batch freed while a queued step still reads it is not handed to the next copy:
    the step's stream spins, then sums batch A; A's last reference is dropped and batch B
    (the same size, another value) is placed on the side stream at once. Without
    `record_stream` the allocator gives B A's memory and B's copy lands there before the
    sum reads it (small and training-size batches)."""
    shape = (clips, 5, hw, hw, 3)
    p = _Placer()
    a = p._ready(p._place({"images": np.full(shape, 1, np.uint8)}))["images"]
    torch.cuda._sleep(200_000_000)  # ~0.1 s on the step's stream
    total = a.to(torch.int64).sum()
    del a
    b = p._ready(p._place({"images": np.full(shape, 2, np.uint8)}))["images"]
    torch.cuda.synchronize()
    assert total.item() == int(np.prod(shape))
    assert torch.equal(b, torch.full_like(b, 2))


def test_workspace_trains_and_resumes_on_the_card(gen, tmp_path):
    """The workspace on the card at a small size (ResNet-18 at 64 px crops, bf16, 2 clips):
    K1 and K2 once a step (K1 also once an eval batch), then a resume with the data
    stream fast-forwarded."""
    from r3m_tpu_torch.data.ego4d import write_synthetic_dataset
    from r3m_tpu_torch.utils.config import load_config

    data = write_synthetic_dataset(str(tmp_path / "data"), n_videos=4, min_len=10,
                                   max_len=16, size=64)
    config = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "cfgs", "config_rep.yaml")

    def run(steps):
        cfg = load_config(config, overrides=[
            f"datapath={data}", f"log_dir={tmp_path / 'run'}", "batch_size=2",
            f"train_steps={steps}", "eval_freq=2", "num_workers=2", "agent.size=18",
            "compute_dtype=bfloat16", "+agent.image_size=64", "n_devices=1"])
        ws = Workspace(cfg)
        try:
            ws.train()
        finally:
            ws.close()
        return ws

    for c in (maxpool_3x3s2_fwd, maxpool_3x3s2_bwd):
        c.launches = 0
    ws = run(3)
    assert ws.device.type == "cuda" and ws.global_step == 3
    assert (maxpool_3x3s2_fwd.launches, maxpool_3x3s2_bwd.launches) == (3 + 2, 3)
    ws = run(5)
    assert ws._train_stream_pos0 == 3 and ws.global_step == 5


@pytest.fixture
def nccl_world_1(gen):
    """A process group of one rank over NCCL on the current card, for this test only."""
    import torch.distributed as dist

    from r3m_tpu_torch.parallel.mesh import init_distributed

    device = init_distributed("true", device=f"cuda:{torch.cuda.current_device()}")
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    try:
        yield device
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype,rounded", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_synced_batchnorm_at_world_1_is_batchnorm(nccl_world_1, dtype, rounded):
    """The data-parallel BatchNorm (sums of x and x^2 all-reduced over NCCL) against
    BatchNorm in f64 on the same channels_last batch (rounded to `dtype`), relative L2
    errors: the output and the input gradient to `rounded` (one rounding to `dtype`), the
    scale and bias gradients and the running statistics, all summed in f32, to 1e-5.
    torch's own BatchNorm in `dtype` is measured the same way, for the message."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from r3m_tpu_torch.models import resnet

    g = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.randn((8, 64, 14, 14), generator=g, device="cuda") * 2 + 0.5).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    up = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
    start = torch.nn.BatchNorm2d(64).cuda()
    with torch.no_grad():
        start.weight.uniform_(0.5, 1.5, generator=g)
        start.bias.uniform_(-0.2, 0.2, generator=g)
    out = {}
    for name in ("f64", "torch", "synced"):
        bn = copy.deepcopy(start).double() if name == "f64" else copy.deepcopy(start)
        leaf = (x.double() if name == "f64" else x.clone()).requires_grad_(True)
        if name == "f64":
            y = F.batch_norm(leaf, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                             training=True, momentum=resnet.BN_MOMENTUM, eps=resnet.BN_EPS)
        elif name == "torch":
            y = resnet._bn_train(leaf, bn)
        else:
            y = resnet._bn_train_synced(leaf, bn, dist.group.WORLD)
        y.backward(up.to(y.dtype))
        out[name] = {"y": y, "dx": leaf.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
                     "mean": bn.running_mean, "var": bn.running_var}
    errors = {name: {k: ((t.double() - out["f64"][k]).norm() / out["f64"][k].norm()).item()
                     for k, t in out[name].items()} for name in ("torch", "synced")}
    bound = {"y": rounded, "dx": rounded, "dw": 1e-5, "db": 1e-5, "mean": 1e-5, "var": 1e-5}
    assert all(errors["synced"][k] <= bound[k] for k in bound), errors


def test_all_gather_rows_at_world_1_over_nccl(nccl_world_1):
    """Gathering over one rank returns the rows, and its backward the gradient."""
    from r3m_tpu_torch.parallel.collectives import all_gather_rows

    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((6, 5, 2048), generator=g, device="cuda").requires_grad_(True)
    up = torch.randn(x.shape, generator=g, device="cuda")
    y = all_gather_rows(x)
    y.backward(up)
    assert torch.equal(y, x) and torch.equal(x.grad, up)


def test_data_parallel_step_keeps_the_kernels_and_the_plain_step_keeps_cudnn(
        nccl_world_1, monkeypatch):
    """The step with no group normalises with torch's BatchNorm, 20 times for ResNet-18;
    the data-parallel step never, and both launch K1 and K2 once a step."""
    import torch.nn.functional as F

    cfg, bert, model, batch, perms, crops = _small_f32_step_inputs()
    calls = []
    real = F.batch_norm
    monkeypatch.setattr(F, "batch_norm", lambda *a, **k: calls.append(1) or real(*a, **k))
    counts = {}
    for mesh in (None, True):
        calls.clear()
        state = create_train_state(cfg, 0, model=copy.deepcopy(model))
        step = make_train_step(cfg, copy.deepcopy(bert), doaug="rctraj", mesh=mesh)
        for c in (maxpool_3x3s2_fwd, maxpool_3x3s2_bwd):
            c.launches = 0
        state, metrics = step(state, batch, perms=perms, crops=crops)
        assert np.isfinite(float(metrics["full_loss"]))
        counts[mesh] = (len(calls), maxpool_3x3s2_fwd.launches, maxpool_3x3s2_bwd.launches)
    assert counts == {None: (20, 1, 1), True: (0, 1, 1)}


def _one_step(device, cfg, bert, model, batch, perms, crops):
    state = create_train_state(cfg, 0, model=copy.deepcopy(model), device=device)
    step = make_train_step(cfg, copy.deepcopy(bert), doaug="rctraj", device=device)
    state, metrics = step(state, batch, perms=perms, crops=crops)
    return (float(metrics["full_loss"]),
            {n: p.grad.cpu() for n, p in state.model.named_parameters()})


@pytest.mark.parametrize("remat,batch_seed", [("none", 11), ("conv_saved", 5)])
def test_train_step_on_the_card_matches_the_cpu(gen, remat, batch_seed):
    """The same f32 ResNet-18 step from the same state, batch, permutations and crops on
    the card and on the CPU: the loss to rtol 1e-4, each gradient leaf to relative L2 error
    1e-3 (what is left is the order of f32 sums). The step sets its own precision (true
    f32), so the caller sets no flag. With ``remat="conv_saved"`` too (its selective
    checkpoint keeps cuDNN's convolution outputs), on the batch of seed 5; "none" on seed
    11. A ReLU input
    within rounding of 0 moves the leaves upstream of it by 1e-3 to 8e-3 between any two
    summation orders, and about half of the seeds 1-10 have one somewhere, for either
    remat: on the card, seed 1's and 2's conv_saved gradients are within 7e-5 of the
    "none" step's, seed 1's CPU conv_saved step flips one (2.6e-3 from the CPU "none"
    step), and seed 2 flips one between card and CPU for both modes (4.6e-3). Seeds 5, 6
    and 7 have none: card against CPU 1.5e-5 for both modes. The premise is asserted on
    the CPU inputs first (``tests/test_torch_relu_margin.py``): seed 1's "none" batch
    has a margin of 0.036 roundings, under the scale, so "none" runs on seed 11 (0.517;
    seed 5 with conv_saved: 0.354)."""
    cfg, *inputs = _small_f32_step_inputs(batch_seed)
    inputs = (dataclasses.replace(cfg, remat=remat), *inputs)
    _, bert, model, batch, perms, crops = inputs
    assert_relu_margin(step_forward(inputs[0], model, batch, perms, crops, bert), batch_seed)
    out = {device: _one_step(device, *inputs) for device in ("cpu", "cuda")}
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for name, want in out["cpu"][1].items():
        got = out["cuda"][1][name]
        floor = 1e-4 * max(g.norm().item() for g in out["cpu"][1].values())
        err = (got - want).norm().item() / max(want.norm().item(), floor)
        assert err <= 1e-3, f"{name}: relative L2 error {err}"


def test_bc_probe_on_the_card_matches_the_cpu(gen):
    """The BC probe's policy trains on the card in true f32: from the same seed (its draws
    come from a CPU generator, so both devices start from the same weights and take the
    same minibatches) the train curve and the validation MSE agree with the CPU's to rtol
    1e-4, the order of f32 sums over 200 Adam steps."""
    from r3m_tpu_torch.evalsuite.bc import bc_probe

    rng = np.random.default_rng(0)
    emb = rng.normal(size=(300, 64)).astype(np.float32)
    actions = np.tanh(emb[:, :2] - emb[:, 2:4]).astype(np.float32)
    out = {device: bc_probe(lambda x: x, emb, actions, steps=200, lr=1e-4, seed=1,
                            device=device)
           for device in ("cpu", "cuda")}
    assert out["cuda"]["policy_params"][0].weight.is_cuda
    np.testing.assert_allclose(out["cuda"]["train_mse_curve"], out["cpu"]["train_mse_curve"],
                               rtol=1e-4)
    np.testing.assert_allclose(out["cuda"]["val_mse"], out["cpu"]["val_mse"], rtol=1e-4)


def test_f32_step_is_true_f32_whatever_the_callers_tf32_flags(gen):
    """With TF32 allowed for cuDNN and for matmuls, the f32 step gives the loss and
    gradients it gives with both off (to 1e-6 relative), and leaves the caller's flags as
    it found them. cuDNN runs deterministic algorithms here: its default weight-gradient
    algorithms sum in an order that changes from run to run (5.7e-5 relative apart on the
    H100), which would hide what TF32 does (~1e-3)."""
    inputs = _small_f32_step_inputs()
    backends = torch.backends
    saved = (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32,
             backends.cudnn.deterministic)
    out = {}
    try:
        backends.cudnn.deterministic = True
        for allow in (False, True):
            backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = allow
            out[allow] = _one_step("cuda", *inputs)
            assert (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32) == (allow, allow)
    finally:
        (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32,
         backends.cudnn.deterministic) = saved
    (loss_off, g_off), (loss_on, g_on) = out[False], out[True]
    assert abs(loss_on - loss_off) <= 1e-6 * abs(loss_off)
    for name, want in g_off.items():
        err = (g_on[name] - want).norm().item()
        assert err <= 1e-6 * want.norm().item(), f"{name}: relative L2 error {err}"

