"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (Hopper, sm_90a) and the CUDA toolkit; without
them each test skips. This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from r3m_tpu_torch.models.distilbert import DistilBert, DistilBertConfig
from r3m_tpu_torch.models.r3m import R3MConfig, R3MEncoder, r3m_init
from r3m_tpu_torch.ops.attention import (
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
# and D at T=50 on either side of those edges, up to the limits T=128 and D=128. 16
# frames, so that the relative L2 error counts many rounding steps and not a handful.
EDGE_SHAPES = ([(16, t, 2, 64) for t in (1, 5, 15, 16, 17, 50, 64, 65, 127, 128)]
               + [(16, 50, 2, d) for d in (8, 16, 32, 128)])
# The f32 kernels' micro-tiles end at multiples of 4 rows and of 4 columns of D: T at D=64
# on either side of those edges and at the longest head each kernel takes (156 forward,
# 124 backward), D at T=50 on either side of multiples of 4 and 8 (D % 4 != 0 takes the
# 4-byte load path).
F32_EDGE_T = (1, 3, 4, 5, 7, 8, 9, 50, 63, 64, 65, 100)
F32_EDGE_D = [(16, 50, 2, d) for d in (4, 6, 12, 32, 128)]
F32_EDGE_SHAPES = [(16, t, 2, 64) for t in (*F32_EDGE_T, 127, 128, 156)] + F32_EDGE_D
F32_EDGE_BWD_SHAPES = [(16, t, 2, 64) for t in (*F32_EDGE_T, 124)] + F32_EDGE_D


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
@pytest.mark.parametrize("t", [17, 50, 64])
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
    """f32 is bounded by shared memory, at D=64 to T up to 156 forward and 124 backward
    (the edge tests run both limits); bf16 by its tiles: T up to 128, D a multiple of 8 up
    to 128. Both need 16-byte aligned tensors."""
    q = torch.randn((1, 157, 64), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        fused_attention(q, q, q, 1)
    q = q[:, :125].contiguous()  # K3 takes it; K4 does not
    fused_attention_fwd(q, q, q, 1)
    with pytest.raises(ValueError, match="shared memory"):
        fused_attention_bwd(q, q, q, q, 1)
    q = torch.randn(50 * 64 + 1, generator=gen, device="cuda")[1:].view(1, 50, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_attention(q, q, q, 1)
    for shape in ((1, 129, 64), (1, 50, 12)):
        q = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        with pytest.raises(ValueError, match="T up to 128 and D a multiple of 8"):
            fused_attention(q, q, q, 1)
        with pytest.raises(ValueError, match="T up to 128 and D a multiple of 8"):
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


def test_train_step_on_the_card_matches_the_cpu(gen):
    """The same f32 ResNet-18 step (TF32 off) from the same state, batch, permutations and
    crops on the card and on the CPU: the loss to rtol 1e-4, each gradient leaf to
    relative L2 error 1e-3 (what is left is the order of f32 sums)."""
    cfg = R3MConfig(size=18, hidden_dim=64, langweight=1.0, image_size=32)
    torch.manual_seed(0)
    bert = DistilBert(DistilBertConfig(vocab_size=100, n_layers=1, n_heads=4,
                                       hidden_dim=128, max_position_embeddings=16))
    model = r3m_init(cfg, 0)
    rng = np.random.default_rng(1)
    batch = {"images": rng.integers(0, 256, (4, 5, 40, 48, 3), np.uint8),
             "token_ids": rng.integers(0, 100, (4, 12)),
             "attn_mask": np.ones((4, 12), np.int64), "lang_mask": np.ones(4, np.float32)}
    perms = {"lang": torch.stack([torch.randperm(4) for _ in range(9)]).reshape(3, 3, 4),
             "tcn": torch.stack([torch.randperm(4) for _ in range(6)]).reshape(3, 2, 4)}
    crops = torch.tensor([[0, 0, 40, 48], [3, 5, 30, 33], [10, 2, 21, 25], [1, 9, 38, 39]],
                         dtype=torch.float32)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for device in ("cpu", "cuda"):
            state = create_train_state(cfg, 0, model=copy.deepcopy(model), device=device)
            step = make_train_step(cfg, copy.deepcopy(bert), doaug="rctraj", device=device)
            state, metrics = step(state, batch, perms=perms, crops=crops)
            out[device] = (float(metrics["full_loss"]),
                           {n: p.grad.cpu() for n, p in state.model.named_parameters()})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for name, want in out["cpu"][1].items():
        got = out["cuda"][1][name]
        floor = 1e-4 * max(g.norm().item() for g in out["cpu"][1].values())
        err = (got - want).norm().item() / max(want.norm().item(), floor)
        assert err <= 1e-3, f"{name}: relative L2 error {err}"
