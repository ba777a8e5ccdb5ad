"""The port's kernel modules and image ops against the JAX package, on the CPU.

A kernel wrapper given CPU tensors computes its plain PyTorch version; these tests hold
those plain versions to the JAX functions they replace (the Pallas kernels in interpret
mode, or the ``lax`` op the JAX serving path runs). The kernels themselves run only on
the card: tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3m_tpu.models.resnet import max_pool_3x3s2 as jax_max_pool
from r3m_tpu.ops.attention import fused_attention as jax_fused_attention
from r3m_tpu.ops.image import r3m_preprocess as jax_preprocess
from r3m_tpu.ops.pallas_pool import maxpool_3x3s2 as pallas_maxpool
from r3m_tpu_torch.ops.attention import fused_attention, fused_attention_reference
from r3m_tpu_torch.ops.image import r3m_preprocess
from r3m_tpu_torch.ops.pool import maxpool_3x3s2, maxpool_3x3s2_reference

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
    np.testing.assert_array_equal(_np(maxpool_3x3s2_reference(xt)), want)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("hw", [(7, 9), (15, 15), (8, 5), (1, 1)])
def test_pool_reference_matches_reduce_window_odd_sizes(rng, dt, hw):
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    xj, xt = _both(x, dt)
    got = maxpool_3x3s2_reference(xt)
    want = np.asarray(jax_max_pool(xj).astype(jnp.float32))
    assert got.shape == want.shape == (2, (hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1, 3)
    np.testing.assert_array_equal(_np(got), want)


def test_pool_reference_propagates_nan_like_reduce_window(rng):
    x = rng.normal(size=(1, 9, 9, 2)).astype(np.float32)
    x[0, 3, 3, 1] = np.nan  # odd position: inside four windows
    got = _np(maxpool_3x3s2_reference(torch.from_numpy(x)))
    want = np.asarray(jax_max_pool(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)  # NaN at the same places
    assert np.isnan(got).sum() == 4


def test_pool_wrapper_on_cpu_uses_the_plain_version(rng):
    x = torch.from_numpy(rng.normal(size=(2, 10, 10, 4)).astype(np.float32))
    before = maxpool_3x3s2.launches
    assert torch.equal(maxpool_3x3s2(x), maxpool_3x3s2_reference(x))
    assert maxpool_3x3s2.launches == before  # no kernel ran
    with pytest.raises(ValueError, match="NHWC"):
        maxpool_3x3s2(x[0])


@pytest.mark.parametrize("b,t,h,d", [(4, 50, 12, 64), (2, 10, 3, 8), (6, 7, 2, 16)])
def test_attention_reference_matches_pallas_kernel_f32(rng, b, t, h, d):
    q, k, v = (rng.standard_normal((b, t, h * d), dtype=np.float32) for _ in range(3))
    want = np.asarray(jax_fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, interpret=True, batched=True
    ))
    got = fused_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)), h)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_attention_reference_matches_pallas_kernel_bf16(rng):
    b, t, h, d = 3, 50, 4, 16
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


def test_attention_wrapper_on_cpu_and_its_checks(rng):
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 5, 12), dtype=np.float32))
               for _ in range(3))
    before = fused_attention.launches
    assert torch.equal(fused_attention(q, k, v, 3), fused_attention_reference(q, k, v, 3))
    assert fused_attention.launches == before
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
