"""DINOv2 with registers in the port (`r3m_tpu_torch.models.dinov2`) on the CPU, at a tiny
size with the published layout: dim 128 (two heads of 64), 2 layers, patch 14, 2
registers, a SwiGLU of 344 (HF's width for mlp_ratio 4), a 4 x 4 position table served at
2 x 2, 3 x 3 and 16 x 16 grids.

The port is held to the benchmark's plain reference (`port_bench/reference/dinov2.py`) on
seeded random weights drawn by the benchmark's own laws, in f32 and in bf16; the reference
to HF's ``Dinov2WithRegistersModel`` loaded with the same state dict; and the comparison
is shown to catch each part of the model left out of the reference."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import r3m_tpu_torch
from port_bench import weights
from port_bench.reference import dinov2 as ref
from port_bench.reference.precision import Arith
from r3m_tpu_torch.convert import convnet_state
from r3m_tpu_torch.models import dinov2
from r3m_tpu_torch.models.r3m import R3MConfig, R3MEncoder
from r3m_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD
from r3m_tpu_torch.utils.profiling import LAYERSCALE, SWIGLU_GATE

BACKBONE = dict(kind="dinov2", patch_size=14, dim=128, n_layers=2, n_heads=2, ffn_dim=344,
                n_registers=2, position_grid=4, layer_norm_eps=1e-6,
                norm_mean=list(IMAGENET_MEAN), norm_std=list(IMAGENET_STD))
CFG = {"backbone": BACKBONE}
# f32 on both sides: the same arithmetic summed in another order; a frame's embedding
# agrees to a few f32 roundings of values of order 1 (seen: 6e-8).
F32_TOL = 1e-5
# bf16 products, attention and residual stream against f32: each rounding is 2^-9 of its
# value, and two layers of them leave a frame's embedding about 0.5% away (seen: 0.45%).
BF16_TOL = 2e-2
GRIDS = {2: 28, 3: 42}  # grid -> pixels


def _params(seed: int = 3):
    return weights.make_tensors(ref.dinov2_specs(BACKBONE), seed, "cpu")


def _images(px: int, n: int = 3, seed: int = 0) -> torch.Tensor:
    return torch.randn((n, 3, px, px), generator=torch.Generator().manual_seed(seed))


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst frame's relative L2 distance, as the benchmark's `embed_gap`."""
    got, want = got.double(), want.double()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


def _reference(p, x):
    return ref.forward(p, x, BACKBONE, Arith("f32"))


def test_config_from_state_reads_every_width():
    cfg = dinov2.dinov2_config_from_state(_params())
    assert cfg == dinov2.Dinov2Config(patch_size=14, dim=128, n_layers=2, n_heads=2,
                                      ffn_dim=344, n_registers=2, grid=4)
    with pytest.raises(ValueError, match="Dinov2WithRegistersModel"):
        dinov2.dinov2_config_from_state({"embeddings.cls_token": torch.zeros(1, 1, 128)})


def test_a_plain_mlp_state_dict_is_refused_by_name():
    """ViT-S/B/L with registers have fc1/fc2 MLPs, not the SwiGLU: refused with the layout
    named, by the config reader and by the loader's routing alike."""
    p = {k: v for k, v in _params().items() if ".mlp." not in k}
    for i in range(BACKBONE["n_layers"]):
        pre = f"encoder.layer.{i}.mlp."
        p.update({pre + "fc1.weight": torch.zeros(512, 128), pre + "fc1.bias": torch.zeros(512),
                  pre + "fc2.weight": torch.zeros(128, 512), pre + "fc2.bias": torch.zeros(128)})
    for read in (dinov2.dinov2_config_from_state, convnet_state):
        with pytest.raises(ValueError, match="SwiGLU.*mlp.fc1.weight"):
            read(p)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_port_matches_reference_in_f32(grid):
    p = _params()
    x = _images(GRIDS[grid])
    model = dinov2.dinov2_from_state(p)
    with torch.no_grad():
        got = model(x)
    assert got.dtype == torch.float32 and got.shape == (3, 128)
    assert _gap(got, _reference(p, x)) <= F32_TOL


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_port_matches_reference_in_bf16(grid):
    p = _params()
    x = _images(GRIDS[grid])
    with torch.no_grad():
        got = dinov2.dinov2_from_state(p)(x, compute_dtype=torch.bfloat16)
    gap = _gap(got, _reference(p, x))
    assert F32_TOL < gap <= BF16_TOL  # bf16 ran, and stays within its rounding


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_reference_matches_transformers(grid):
    try:
        from transformers import Dinov2WithRegistersConfig, Dinov2WithRegistersModel
    except ImportError:
        pytest.skip("this transformers has no Dinov2WithRegistersModel")
    hf = Dinov2WithRegistersModel(Dinov2WithRegistersConfig(
        hidden_size=128, num_hidden_layers=2, num_attention_heads=2, mlp_ratio=4,
        image_size=56, patch_size=14, use_swiglu_ffn=True, num_register_tokens=2,
        layer_norm_eps=1e-6)).eval()
    p = _params()
    hf.load_state_dict({**p, "embeddings.mask_token": torch.zeros(1, 128)})
    x = _images(GRIDS[grid])
    with torch.no_grad():
        want = hf(pixel_values=x).pooler_output
    assert _gap(_reference(p, x), want) <= F32_TOL


def _no_layer_scale(branch, scale):
    return branch


def _no_registers(h, registers):
    return h


def _gelu_gate(x1, x2):
    return F.gelu(x1) * x2


def _table_not_resized(table, height, width, patch):
    return table[:, :1 + (height // patch) * (width // patch)]


@pytest.mark.parametrize("part,fault", [
    ("layer_scale", _no_layer_scale), ("with_registers", _no_registers),
    ("gate", _gelu_gate), ("resize_positions", _table_not_resized)])
def test_each_part_left_out_fails_the_f32_comparison(monkeypatch, part, fault):
    p = _params()
    x = _images(GRIDS[3])
    with torch.no_grad():
        got = dinov2.dinov2_from_state(p)(x)
    monkeypatch.setattr(ref, part, fault)
    assert _gap(got, _reference(p, x)) > 100 * F32_TOL


def _model_pt(tmp_path, sd, prefix="convnet."):
    path = str(tmp_path / "model.pt")
    torch.save({prefix + k: v for k, v in sd.items()}, path)
    return path


@pytest.mark.parametrize("precision,tol", [("parity", F32_TOL), ("fast", BF16_TOL)])
def test_load_r3m_from_files_serves_the_backbone(tmp_path, precision, tol):
    """An R3M-layout ``model.pt`` of HF-named ``convnet.*`` weights (with HF's
    ``mask_token``), served at R3M's 224 px crop: a 16 x 16 grid from the 4 x 4 table."""
    p = _params()
    path = _model_pt(tmp_path, {**p, "embeddings.mask_token": torch.zeros(1, 128)})
    enc = r3m_tpu_torch.load_r3m_from_files(path, precision=precision, device="cpu")
    assert enc.cfg.size == dinov2.NAME and enc.cfg.backbone == "dinov2"
    assert enc.outdim == 128 and enc.cfg.norm_stats == (IMAGENET_MEAN, IMAGENET_STD)
    frames = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 3, 224, 224),
                                                                dtype=np.uint8))
    got = enc(frames)
    want = ref.serve(CFG, p, frames, Arith("f32"))
    assert got.shape == (2, 128) and _gap(got, want) <= tol
    if precision == "fast":
        assert _gap(got, want) > F32_TOL


def test_a_bare_hf_state_dict_is_a_dinov2_backbone(tmp_path):
    p = _params()
    enc, size, image_size = convnet_state({**p, "embeddings.mask_token": torch.zeros(1, 128)})
    assert size == dinov2.NAME and image_size is None and len(enc) == len(p) + 1
    path = _model_pt(tmp_path, p, prefix="")
    assert r3m_tpu_torch.load_r3m_from_files(path, device="cpu").cfg.size == dinov2.NAME


def test_positions_follow_the_table():
    p = _params()
    enc = R3MEncoder(R3MConfig(size=dinov2.NAME, image_size=42), p, device="cpu")
    net = enc.convnet
    frames = np.random.default_rng(1).integers(0, 256, (2, 3, 42, 42), dtype=np.uint8)
    first = enc(frames)
    for _ in range(3):
        assert torch.equal(enc(frames), first)
    with torch.no_grad():  # another grid
        other = net(_images(28))
    assert torch.equal(net(_images(28)).detach(), other)  # with a gradient to keep
    with torch.no_grad():  # a change to the table is seen, as the weight check sees one
        net.embeddings.position_embeddings.mul_(2.0)
    assert not torch.equal(enc(frames), first)


def test_r3m_config_names_the_backbone():
    cfg = R3MConfig(size=dinov2.NAME)
    assert cfg.backbone == "dinov2" and cfg.out_dim == 1536
    assert (R3MConfig(size=0).backbone, R3MConfig(size=50).backbone) == ("vit", "resnet")
    with pytest.raises(ValueError, match="remat"):
        R3MConfig(size=dinov2.NAME, remat="conv_saved")
    with pytest.raises(ValueError, match="vit_fused_attn"):
        R3MConfig(size=dinov2.NAME, vit_fused_attn=True)
    assert dataclasses.replace(cfg, size=18).backbone == "resnet"


def test_spans_mark_the_gate_and_each_layer_scale():
    model = dinov2.dinov2_from_state(_params())
    x = _images(28, n=1)
    with torch.no_grad():
        off = model(x)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            on = model(x)
    names = [e.name for e in prof.events()]
    assert names.count(SWIGLU_GATE) == 2 and names.count(LAYERSCALE) == 4
    assert torch.equal(on, off)
