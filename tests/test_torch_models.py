"""The port's models and weight carry against the JAX package, on the CPU.

Weights are made by the JAX package from a seed and carried over with
`r3m_tpu_torch.convert.state_dict_from_jax`; inputs come from a numpy seed and go
through both packages.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3m_tpu.convert import export_r3m_torch_state
from r3m_tpu.models import resnet as jresnet
from r3m_tpu.models import vit as jvit
from r3m_tpu.models.r3m import R3MConfig as JaxR3MConfig, r3m_init
from r3m_tpu_torch.convert import (
    convnet_state,
    detect_resnet_size,
    state_dict_from_jax,
    strip_prefix,
)
from r3m_tpu_torch.models.resnet import (
    ResNet,
    fold_batchnorm,
    resnet_apply_folded,
    resnet_out_dim,
)
from r3m_tpu_torch.models.vit import (
    ViT,
    ViTConfig,
    require_b32_geometry,
    vit_config_from_state,
)

HIGHEST = jax.lax.Precision.HIGHEST
SMALL_VIT = dict(image_size=32, patch_size=8, dim=64, n_layers=2, n_heads=4, hidden_dim=128)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_resnet(size, seed=3):
    """JAX ResNet params with non-trivial BN statistics, as numpy."""
    key = jax.random.PRNGKey(seed)
    params, state = jresnet.resnet_init(key, size)
    state = jax.tree_util.tree_map(
        lambda x: x + jnp.abs(jax.random.normal(key, x.shape)) * 0.1, state
    )
    return _np_tree(params), _np_tree(state)


def _port_resnet(params, state, size) -> ResNet:
    sd = state_dict_from_jax({"convnet": params}, state, size, data_parallel=False)
    net = ResNet(size)
    net.load_state_dict(strip_prefix(sd, "convnet."))
    return net.eval()


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last
    )


@pytest.mark.parametrize("size", [18, 34, 50])
def test_resnet_keys_are_torchvisions(size):
    path = os.path.join(os.path.dirname(__file__), "data", "torchvision_resnet_manifest.json")
    with open(path) as f:
        manifest = {k: tuple(v) for k, v in json.load(f)[str(size)].items()
                    if not k.startswith("fc.")}
    got = {k: tuple(v.shape) for k, v in ResNet(size).state_dict().items()}
    assert got == manifest
    assert resnet_out_dim(size) == jresnet.resnet_out_dim(size)


@pytest.mark.parametrize("size,lang", [(18, False), (50, True), (0, False)])
def test_state_dict_from_jax_equals_export(size, lang):
    cfg = JaxR3MConfig(size=size, image_size=64, langweight=1.0 if lang else 0.0)
    state = _np_tree(r3m_init(jax.random.PRNGKey(0), cfg))
    want = export_r3m_torch_state(state["params"], state["batch_stats"], size)
    got = state_dict_from_jax(state["params"], state["batch_stats"], size)
    assert list(got) == list(want)
    for k, v in want.items():
        assert isinstance(got[k], torch.Tensor)
        assert got[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("size", [18, 50])
def test_fold_batchnorm_matches_jax(size):
    params, state = _jax_resnet(size)
    want = _np_tree(jresnet.fold_batchnorm(params, state, size))
    got = fold_batchnorm(_port_resnet(params, state, size))
    np.testing.assert_allclose(
        got["conv1"]["w"].permute(2, 3, 1, 0).numpy(), want["conv1"]["w"], rtol=1e-6, atol=1e-7
    )
    last = got["layer4"][-1]["conv2"]
    np.testing.assert_allclose(
        last["w"].permute(2, 3, 1, 0).numpy(), want["layer4"][-1]["conv2"]["w"],
        rtol=1e-6, atol=1e-7,
    )
    np.testing.assert_allclose(last["b"].numpy(), want["layer4"][-1]["conv2"]["b"],
                               rtol=1e-6, atol=1e-6)
    assert got["layer2"][0]["downsample"]["w"].is_contiguous(
        memory_format=torch.channels_last
    )


@pytest.mark.parametrize("size", [18, 50])
def test_folded_forward_matches_jax(rng, size):
    params, state = _jax_resnet(size)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jresnet.resnet_apply_folded(
        jresnet.fold_batchnorm(params, state, size), jnp.asarray(x), size=size,
        precision=HIGHEST,
    ))
    net = _port_resnet(params, state, size)
    with torch.inference_mode():
        got = resnet_apply_folded(fold_batchnorm(net), _nchw(x), size=size)
    assert got.dtype == torch.float32 and got.shape == (2, resnet_out_dim(size))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_unfolded_forward_matches_jax_eval(rng):
    size = 18
    params, state = _jax_resnet(size)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    want, _ = jresnet.resnet_apply(
        params, state, jnp.asarray(x), size=size, train=False, precision=HIGHEST
    )
    net = _port_resnet(params, state, size).train()  # eval BN whatever the mode
    with torch.inference_mode():
        got = net(_nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_folded_forward_bf16_tracks_f32(rng):
    size = 18
    params, state = _jax_resnet(size)
    folded = fold_batchnorm(_port_resnet(params, state, size))
    x = _nchw(rng.normal(size=(2, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        f32 = resnet_apply_folded(folded, x, size=size)
        bf16 = resnet_apply_folded(folded, x, size=size, compute_dtype=torch.bfloat16)
    assert bf16.dtype == torch.float32
    cos = torch.nn.functional.cosine_similarity(f32, bf16)
    assert torch.all(cos >= 0.995), cos


def _small_vit_params(seed=0):
    cfg = jvit.ViTConfig(**SMALL_VIT)
    params = _np_tree(jvit.vit_b32_init(jax.random.PRNGKey(seed), cfg))
    # non-trivial LayerNorm affine terms and biases, so every parameter is exercised
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    leaves = [v + rng.normal(scale=0.05, size=v.shape).astype(np.float32) for v in leaves]
    return cfg, jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.mark.parametrize("jax_attention", [False, "batched"], ids=["einsum", "pallas"])
def test_vit_forward_matches_jax(rng, jax_attention):
    jcfg, params = _small_vit_params()
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jvit.vit_b32_apply(
        params, jnp.asarray(x), jcfg, precision=HIGHEST,
        fused_attn=jax_attention, fused_attn_interpret=True,
    ))
    sd = state_dict_from_jax({"convnet": params}, {}, 0, data_parallel=False)
    net = ViT(ViTConfig(**SMALL_VIT))
    net.load_state_dict(strip_prefix(sd, "convnet."))
    with torch.inference_mode():
        got = net(_nchw(x))
    assert got.dtype == torch.float32 and got.shape == (2, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_vit_forward_of_a_long_head_matches_jax(rng):
    """T = 145 tokens (12 x 12 patches and the class token, as ViT-B/32 at 384 px has),
    more than one block of the card's attention kernels holds: the port's forward against
    the JAX forward through its Pallas kernel (interpret mode)."""
    geometry = dict(SMALL_VIT, image_size=96, patch_size=8)
    jcfg = jvit.ViTConfig(**geometry)
    params = _np_tree(jvit.vit_b32_init(jax.random.PRNGKey(1), jcfg))
    x = rng.normal(size=(2, 96, 96, 3)).astype(np.float32)
    want = np.asarray(jvit.vit_b32_apply(
        params, jnp.asarray(x), jcfg, precision=HIGHEST,
        fused_attn="batched", fused_attn_interpret=True,
    ))
    net = ViT(ViTConfig(**geometry))
    assert net.embeddings.position_embeddings.shape[1] == 145
    sd = state_dict_from_jax({"convnet": params}, {}, 0, data_parallel=False)
    net.load_state_dict(strip_prefix(sd, "convnet."))
    with torch.inference_mode():
        got = net(_nchw(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_vit_bf16_forward_of_a_long_head_matches_jax(rng):
    """The same T = 145 forward in bf16, the port's (whose attention, on the card, is K3's
    one-block-a-head kernel, held there to this plain version) against `vit_b32_apply` in
    bf16 through the Pallas kernel (interpret mode). The two round the GEMMs' outputs and
    the residual stream in bf16 at different places, so they are as far apart as each is
    from its f32 forward. Measured on input seeds 0-9: relative L2 4.4e-3 to 5.4e-3
    between them (4.4e-3 at this test's seed 0; each 4.9e-3 to 6.6e-3 from f32), max abs
    at most 3.9e-3 (two bf16 steps of the tanh-bounded pooled output), cosine at least
    0.99998. Held to relative L2 1e-2, max abs 1e-2 and cosine 0.9999."""
    geometry = dict(SMALL_VIT, image_size=96, patch_size=8)
    jcfg = jvit.ViTConfig(**geometry)
    params = _np_tree(jvit.vit_b32_init(jax.random.PRNGKey(1), jcfg))
    x = rng.normal(size=(2, 96, 96, 3)).astype(np.float32)
    want = np.asarray(jvit.vit_b32_apply(
        params, jnp.asarray(x), jcfg, compute_dtype=jnp.bfloat16,
        fused_attn="batched", fused_attn_interpret=True,
    ))
    net = ViT(ViTConfig(**geometry))
    sd = state_dict_from_jax({"convnet": params}, {}, 0, data_parallel=False)
    net.load_state_dict(strip_prefix(sd, "convnet."))
    with torch.inference_mode():
        got = net(_nchw(x), compute_dtype=torch.bfloat16).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (2, 64)
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)
    assert np.abs(got - want).max() <= 1e-2
    cos = np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert np.all(cos >= 0.9999), cos


def _np_vit_params(rng, cfg):
    """A ViT's parameters drawn from a numpy generator in the JAX package's tree: weights
    N(0, 1/fan_in), so that the scores reach O(1) and each softmax row is far from
    uniform (the pooler's a tenth of that, so its tanh stays off its rails), LayerNorm
    scales 1 + 0.1 N(0, 1), biases 0.1 N(0, 1)."""
    shapes = jax.eval_shape(lambda: jvit.vit_b32_init(jax.random.PRNGKey(0), cfg))

    def draw(path, leaf):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if leaf.ndim == 1 or name in ("bias", "b"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        gain = 0.1 if path[0].key == "pooler" else 1.0
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (gain * rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_vit_f32_forward_of_a_long_head_matches_jax(rng):
    """The T = 145 forward in f32 (ViT-B/32 at 384 px has that many tokens; on the card its
    attention is K3's f32 head kernel, held there to this plain version) from numpy-drawn
    weights, through both packages: the JAX forward at HIGHEST precision through its
    Pallas kernel (interpret mode). Both are true f32 and differ only in the order of
    sums. Measured on seeds 0-9 (weights and input): relative L2 1.8e-7 to 2.8e-7, max
    abs 7.5e-8 to 1.2e-7 of outputs up to ~0.3-0.45. Held to relative L2 2e-6 and max
    abs 1e-6."""
    geometry = dict(SMALL_VIT, image_size=96, patch_size=8)
    jcfg = jvit.ViTConfig(**geometry)
    params = _np_vit_params(rng, jcfg)
    x = rng.normal(size=(2, 96, 96, 3)).astype(np.float32)
    want = np.asarray(jvit.vit_b32_apply(
        params, jnp.asarray(x), jcfg, precision=HIGHEST,
        fused_attn="batched", fused_attn_interpret=True,
    ))
    net = ViT(ViTConfig(**geometry))
    assert net.embeddings.position_embeddings.shape[1] == 145
    sd = state_dict_from_jax({"convnet": params}, {}, 0, data_parallel=False)
    net.load_state_dict(strip_prefix(sd, "convnet."))
    with torch.inference_mode():
        got = net(_nchw(x)).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (2, 64)
    assert np.linalg.norm(got - want) <= 2e-6 * np.linalg.norm(want)
    assert np.abs(got - want).max() <= 1e-6


def test_vit_keys_and_config_inference_match_jax():
    """The port's ViT state dict is what the JAX exporter writes, and both packages
    read the same config back from it."""
    jcfg, params = _small_vit_params()
    exported = jvit.export_vit(params)
    port = ViT(ViTConfig(**SMALL_VIT)).state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == {
        k: tuple(np.shape(v)) for k, v in exported.items()
    }
    assert dataclasses.asdict(vit_config_from_state(port)) == dataclasses.asdict(
        jvit.vit_config_from_state(exported)
    )


@pytest.mark.parametrize(
    "geometry", [{}, {"dim": 64}, {"n_layers": 2}, {"patch_size": 16}],
    ids=["b32", "dim", "layers", "patch"],
)
def test_require_b32_geometry_matches_jax(geometry):
    cfg = ViTConfig(**geometry)
    jcfg = jvit.ViTConfig(**geometry)
    try:
        jvit.require_b32_geometry(jcfg)
        jax_error = None
    except ValueError as e:
        jax_error = str(e)
    if jax_error is None:
        require_b32_geometry(cfg)
    else:
        with pytest.raises(ValueError) as info:
            require_b32_geometry(cfg)
        assert str(info.value) == jax_error


def test_convnet_state_and_size_detection():
    from r3m_tpu.convert import detect_resnet_size as jax_detect

    for size in (18, 34, 50):
        sd = {f"module.convnet.{k}": v for k, v in ResNet(size).state_dict().items()}
        sd["module.lang_rew.pred.0.weight"] = torch.zeros(1)
        enc, got_size, image_size = convnet_state(sd)
        assert got_size == size == jax_detect(sd, prefix="module.convnet.")
        assert detect_resnet_size(sd, prefix="module.convnet.") == size
        assert image_size is None
        assert set(enc) == set(ResNet(size).state_dict())
    with pytest.raises(ValueError, match="ViT-B/32"):
        convnet_state({f"convnet.{k}": v
                       for k, v in ViT(ViTConfig(**SMALL_VIT)).state_dict().items()})
