"""The port's kernel modules and image ops against the JAX package, on the CPU.

A kernel wrapper given CPU tensors computes its plain PyTorch version; these tests hold
those plain versions, forward and backward, to the JAX functions they replace (the Pallas
kernels in interpret mode, or the ``lax`` op the JAX path runs, differentiated with
``jax.vjp``). The kernels themselves run only on the card: tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3m_tpu.models.resnet import _amax_pool_fwd
from r3m_tpu.models.resnet import max_pool_3x3s2 as jax_max_pool
from r3m_tpu.ops.attention import fused_attention as jax_fused_attention
from r3m_tpu.ops.image import r3m_preprocess as jax_preprocess
from r3m_tpu.ops.pallas_pool import maxpool_3x3s2 as pallas_maxpool
from r3m_tpu_torch.ops.attention import (
    fused_attention,
    fused_attention_bwd,
    fused_attention_bwd_reference,
    fused_attention_fwd,
    fused_attention_reference,
)
from r3m_tpu_torch.ops.image import r3m_preprocess
from r3m_tpu_torch.ops.pool import (
    maxpool_3x3s2,
    maxpool_3x3s2_bwd,
    maxpool_3x3s2_bwd_reference,
    maxpool_3x3s2_fwd,
    maxpool_3x3s2_reference,
)

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _both(x: np.ndarray, dt: str):
    _, jdt, tdt = DTYPES[dt]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("values", ["normal", "ties"])
def test_pool_reference_matches_pallas_kernel(rng, dt, values):
    """Even H/W, bit-exact against the Pallas forward; "ties" draws from {0, 1, 2}, so
    most windows hold several equal maxima."""
    shape = (2, 16, 12, 8)
    x = (rng.normal(size=shape) if values == "normal"
         else rng.integers(0, 3, size=shape)).astype(np.float32)
    xj, xt = _both(x, dt)
    want = np.asarray(pallas_maxpool(xj, True).astype(jnp.float32))
    np.testing.assert_array_equal(_np(maxpool_3x3s2_reference(xt)[0]), want)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("hw", [(7, 9), (15, 15), (8, 5), (1, 1)])
def test_pool_reference_matches_reduce_window_odd_sizes(rng, dt, hw):
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    xj, xt = _both(x, dt)
    got, _ = maxpool_3x3s2_reference(xt)
    want = np.asarray(jax_max_pool(xj).astype(jnp.float32))
    assert got.shape == want.shape == (2, (hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1, 3)
    np.testing.assert_array_equal(_np(got), want)


def test_pool_reference_propagates_nan_like_reduce_window(rng):
    x = rng.normal(size=(1, 9, 9, 2)).astype(np.float32)
    x[0, 3, 3, 1] = np.nan  # odd position: inside four windows
    got = _np(maxpool_3x3s2_reference(torch.from_numpy(x))[0])
    want = np.asarray(jax_max_pool(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)  # NaN at the same places
    assert np.isnan(got).sum() == 4


# The last two put whole 16-byte channel vectors under the kernels (C = 8, 16) and leave a
# remainder after K1's strips of two outputs and K2's 2x2 owner blocks (W = 14 pools to 7,
# H = 13 and W = 11 are odd).
POOL_SHAPES = [(2, 16, 12, 8), (2, 7, 9, 3), (1, 15, 15, 4), (2, 8, 5, 3), (1, 1, 1, 2),
               (2, 10, 14, 8), (1, 13, 11, 16)]


def _pool_input(rng, shape, values):
    """"ties" draws ReLU'd integers, so most windows hold several equal maxima (and
    all-zero windows), as bf16 stem activations do."""
    if values == "ties":
        return np.maximum(rng.integers(-2, 3, size=shape), 0).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("values", ["normal", "ties"])
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_pool_argmax_matches_amax_pool(rng, dt, values, shape):
    """The argmax is the first maximum in window order, as `_amax_pool_fwd` picks it."""
    xj, xt = _both(_pool_input(rng, shape, values), dt)
    want_y, want_idx = _amax_pool_fwd(xj, xj.shape, str(xj.dtype))
    y, idx = maxpool_3x3s2_reference(xt)
    assert idx.dtype == torch.int8
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(_np(y), np.asarray(want_y.astype(jnp.float32)))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("values", ["normal", "ties"])
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_pool_backward_matches_reduce_window_vjp(rng, dt, values, shape):
    """K2's plain version, and the gradient through `maxpool_3x3s2`, against `jax.vjp`
    of the JAX stem's `reduce_window` (select-and-scatter: the first maximum).

    Which elements receive gradient must agree exactly. Where an element takes the
    gradient of several windows, select-and-scatter adds in its own order (and in bf16
    rounds after each add) while the port sums in f32 and rounds once: the values agree
    to f32 rounding, or to one bf16 rounding step.
    """
    xj, xt = _both(_pool_input(rng, shape, values), dt)
    y, vjp = jax.vjp(jax_max_pool, xj)
    g = rng.normal(size=y.shape).astype(np.float32)
    gj, gt = _both(g, dt)
    (want,) = vjp(gj)
    want = np.asarray(want.astype(jnp.float32))
    tol = {"f32": 1e-6, "bf16": 2.0**-7}[dt]
    _, idx = maxpool_3x3s2_reference(xt)
    got = maxpool_3x3s2_bwd_reference(idx, gt, *shape[1:3])
    assert got.dtype == xt.dtype and tuple(got.shape) == shape
    x_leaf = xt.clone().requires_grad_(True)
    maxpool_3x3s2(x_leaf).backward(gt)
    assert torch.equal(x_leaf.grad, got)
    np.testing.assert_array_equal(_np(got) != 0, want != 0)
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)


def test_pool_gradient_is_not_split_on_ties():
    """Autograd of a chain of `torch.maximum` would split a tie 50/50; the port sends the
    whole gradient to the first maximum."""
    x = torch.zeros((1, 3, 3, 1), requires_grad=True)
    maxpool_3x3s2(x).sum().backward()
    # Window (oy, ox) covers rows and columns {2o-1, 2o, 2o+1}; its first valid element
    # is (max(2oy-1, 0), max(2ox-1, 0)): (0,0), (0,1), (1,0), (1,1).
    want = torch.zeros((1, 3, 3, 1))
    for r, c in ((0, 0), (0, 1), (1, 0), (1, 1)):
        want[0, r, c, 0] += 1.0
    assert torch.equal(x.grad, want)


def test_pool_kernel_wrappers_on_cpu(rng):
    x = torch.from_numpy(_pool_input(rng, (2, 9, 7, 3), "ties"))
    y, idx = maxpool_3x3s2_fwd(x, argmax=True)
    assert maxpool_3x3s2_fwd(x)[1] is None
    before = maxpool_3x3s2_bwd.launches
    dx = maxpool_3x3s2_bwd(idx, y, 9, 7)
    assert maxpool_3x3s2_bwd.launches == before
    assert torch.equal(dx, maxpool_3x3s2_bwd_reference(idx, y, 9, 7))
    with pytest.raises(ValueError, match="do not pool"):
        maxpool_3x3s2_bwd(idx, y, 12, 7)


def test_pool_wrapper_on_cpu_uses_the_plain_version(rng):
    x = torch.from_numpy(rng.normal(size=(2, 10, 10, 4)).astype(np.float32))
    before = maxpool_3x3s2_fwd.launches
    assert torch.equal(maxpool_3x3s2(x), maxpool_3x3s2_reference(x)[0])
    assert maxpool_3x3s2_fwd.launches == before  # no kernel ran
    with pytest.raises(ValueError, match="NHWC"):
        maxpool_3x3s2(x[0])


# Where the bf16 kernels' tiles of 16 rows and 16 columns of D end: T on either side of
# 16 and 64 and at the limit 128 (D=64), D at 8 and at the limit 128 (T=50).
EDGE_SHAPES = ([(2, t, 2, 64) for t in (16, 17, 64, 65, 128)]
               + [(2, 50, 2, d) for d in (8, 128)])
# Where the f32 kernels' 4 x 4 micro-tiles end: T on either side of multiples of 4 (D=64),
# and D not a multiple of 4 (the kernels' 4-byte load path).
F32_EDGE_SHAPES = ([(2, t, 2, 64) for t in (1, 3, 4, 5, 9)]
                   + [(2, 50, 2, 12), (2, 50, 2, 6), (2, 9, 3, 6)])


@pytest.mark.parametrize("b,t,h,d", [(4, 50, 12, 64), (2, 10, 3, 8), (6, 7, 2, 16),
                                     *EDGE_SHAPES, *F32_EDGE_SHAPES])
def test_attention_reference_matches_pallas_kernel_f32(rng, b, t, h, d):
    q, k, v = (rng.standard_normal((b, t, h * d), dtype=np.float32) for _ in range(3))
    want = np.asarray(jax_fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, interpret=True, batched=True
    ))
    got = fused_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)), h)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,t,h,d", [(3, 50, 4, 16), *EDGE_SHAPES])
def test_attention_reference_matches_pallas_kernel_bf16(rng, b, t, h, d):
    q, k, v = (rng.standard_normal((b, t, h * d), dtype=np.float32) for _ in range(3))
    want = np.asarray(jax_fused_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), h,
        interpret=True, batched=True,
    ).astype(jnp.float32))
    got = fused_attention_reference(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), h
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, rtol=0.05, atol=0.05)


def _jax_attention_vjp(q, k, v, do, h):
    _, vjp = jax.vjp(
        lambda a, b, c: jax_fused_attention(a, b, c, h, interpret=True, batched=True),
        q, k, v,
    )
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(do)]


@pytest.mark.parametrize("b,t,h,d", [(4, 50, 12, 64), (2, 10, 3, 8), *EDGE_SHAPES,
                                     *F32_EDGE_SHAPES])
def test_attention_backward_matches_pallas_kernel_f32(rng, b, t, h, d):
    """K4's plain version, and the gradient through `fused_attention`, against the
    Pallas backward (interpret mode, the batched lowering the JAX trainer runs)."""
    q, k, v, do = (rng.standard_normal((b, t, h * d), dtype=np.float32) for _ in range(4))
    want = _jax_attention_vjp(*(jnp.asarray(a) for a in (q, k, v, do)), h)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    got = fused_attention_bwd_reference(qt, kt, vt, dot, h)
    leaves = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    fused_attention(*leaves, h).backward(dot)
    for g, leaf, w in zip(got, leaves, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5)
        assert torch.equal(leaf.grad, g)


def _rel_l2(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.linalg.norm(_np(got) - want) / np.linalg.norm(want))


@pytest.mark.parametrize("b,t,h,d", [(3, 50, 4, 16), *EDGE_SHAPES])
def test_attention_backward_matches_pallas_kernel_bf16(rng, b, t, h, d):
    """In bf16 P is rounded for dV and dU for dQ/dK, in both packages; the sums' order
    differs, so elements agree to a few ulps of values of order 1 (atol 0.05), and each
    gradient to relative L2 error 5e-4: an element in a few thousand lands one rounding
    step apart. Without those two roundings the gradients are ~3e-3 away, which the
    relative L2 bound tells apart, as the check on autograd of the plain forward (which
    does not round dU) shows."""
    q, k, v, do = (rng.standard_normal((b, t, h * d), dtype=np.float32) for _ in range(4))
    want = _jax_attention_vjp(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do)), h)
    qt, kt, vt, dot = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    got = fused_attention_bwd_reference(qt, kt, vt, dot, h)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(g), w, rtol=0.05, atol=0.05)
        assert _rel_l2(g, w) <= 5e-4
    leaves = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    unrounded = torch.autograd.grad(fused_attention_reference(*leaves, h), leaves, dot)
    assert min(_rel_l2(g, w) for g, w in zip(unrounded[:2], want[:2])) > 2e-3


def test_attention_backward_agrees_with_autograd_of_the_forward(rng):
    """In f32 the recompute-P backward is the exact gradient of the plain forward."""
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 7, 12), dtype=np.float32))
                   for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fused_attention_reference(*leaves, 3).backward(do)
    got = fused_attention_bwd_reference(q, k, v, do, 3)
    for g, leaf in zip(got, leaves):
        torch.testing.assert_close(g, leaf.grad, rtol=1e-5, atol=1e-6)
    before = fused_attention_bwd.launches
    assert all(torch.equal(a, b) for a, b in zip(fused_attention_bwd(q, k, v, do, 3), got))
    assert fused_attention_bwd.launches == before


def test_attention_wrapper_on_cpu_and_its_checks(rng):
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 5, 12), dtype=np.float32))
               for _ in range(3))
    before = fused_attention_fwd.launches
    assert torch.equal(fused_attention(q, k, v, 3), fused_attention_reference(q, k, v, 3))
    assert fused_attention_fwd.launches == before
    with pytest.raises(ValueError, match="divisible"):
        fused_attention(q, k, v, 5)
    with pytest.raises(ValueError, match="shape"):
        fused_attention(q, k[:, :4], v, 3)


@pytest.mark.parametrize(
    "hw,crop,resize_to",
    [((30, 47), 16, 18), ((47, 30), 16, 18), ((240, 320), 224, 256), ((12, 9), 16, 10),
     ((16, 16), 16, 18)],
    ids=["wide", "tall", "serving", "pad", "crop-size"],
)
def test_preprocess_matches_jax(rng, hw, crop, resize_to):
    """Non-square inputs through resize (truncated long edge), centre crop (zero pad
    when smaller) and normalisation; the JAX function is the reference."""
    obs = rng.integers(0, 256, size=(2, *hw, 3)).astype(np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    want = np.asarray(jax_preprocess(jnp.asarray(obs), mean, std, crop, resize_to))
    got = r3m_preprocess(torch.from_numpy(obs), mean, std, crop, resize_to)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_dense_and_layer_norm_match_jax(rng, dt):
    from r3m_tpu.models.layers import dense as jax_dense, layer_norm as jax_layer_norm
    from r3m_tpu_torch.models.layers import dense, layer_norm

    x = rng.standard_normal((2, 5, 16), dtype=np.float32)
    w = rng.standard_normal((16, 8), dtype=np.float32) * 0.3  # JAX layout [in, out]
    b = rng.standard_normal(8, dtype=np.float32)
    scale = rng.standard_normal(16, dtype=np.float32)
    xj, xt = _both(x, dt)
    precision = jax.lax.Precision.HIGHEST
    want = np.asarray(jax_dense(xj, {"w": w, "b": b}, precision).astype(jnp.float32))
    got = dense(xt, torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    tol = 1e-5 if dt == "f32" else 1e-2
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)
    want = np.asarray(jax_layer_norm(xj, {"scale": scale, "bias": b[:1]}, 1e-12)
                      .astype(jnp.float32))
    got = layer_norm(xt, torch.from_numpy(scale), torch.from_numpy(b[:1]), 1e-12)
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)
