"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (Hopper, sm_90a) and the CUDA toolkit; without
them each test skips. This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from r3m_tpu_torch.models.r3m import R3MConfig, R3MEncoder
from r3m_tpu_torch.ops.attention import fused_attention, fused_attention_reference
from r3m_tpu_torch.ops.pool import maxpool_3x3s2, maxpool_3x3s2_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels run only on CUDA tensors")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 112, 112, 64), (3, 7, 9, 5), (1, 1, 1, 3)])
def test_pool_kernel_is_exact(gen, dtype, shape):
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    before = maxpool_3x3s2.launches
    y = maxpool_3x3s2(x)
    torch.cuda.synchronize()
    assert maxpool_3x3s2.launches == before + 1
    assert torch.equal(y, maxpool_3x3s2_reference(x))


def test_pool_kernel_ties_and_nan(gen):
    x = torch.randint(0, 3, (2, 10, 10, 8), generator=gen, device="cuda").float()
    x[0, 3, 3, 1] = float("nan")
    y, ref = maxpool_3x3s2(x), maxpool_3x3s2_reference(x)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(y.cpu().numpy(), ref.cpu().numpy())
    assert torch.isnan(y).sum().item() == 4


def test_pool_kernel_rejects_what_it_does_not_take(gen):
    x = torch.randn((2, 8, 8, 4), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        maxpool_3x3s2(x.permute(0, 2, 1, 3))
    with pytest.raises(TypeError, match="bfloat16"):
        maxpool_3x3s2(x.half())


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,t,h,d", [(4, 50, 12, 64), (2, 10, 3, 8), (3, 7, 2, 16),
                                     (2, 120, 2, 64)])
def test_attention_kernel_matches_plain_version(gen, dtype, atol, b, t, h, d):
    q, k, v = (torch.randn((b, t, h * d), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    before = fused_attention.launches
    o = fused_attention(q, k, v, h)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    assert o.dtype == dtype and o.shape == q.shape
    ref = fused_attention_reference(q, k, v, h)
    assert (o.float() - ref.float()).abs().max().item() <= atol


def test_attention_kernel_rejects_a_head_too_long_for_shared_memory(gen):
    q = torch.randn((1, 300, 64), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
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
