"""Shared pieces of the benchmark's tests: cells cut to a size the CPU runs in seconds
(ResNet-18 and ViT-B/32 at 64 px, a DistilBERT of one narrow layer, 4 clips), with the
shapes, laws and code paths of the real ones."""

from __future__ import annotations

import copy

from port_bench import harness

CELLS = ("train_resnet50", "train_vit_b32", "serve_resnet50_control", "serve_vit_b32_b256")
SEED = 2**31 + 17  # past 32 signed bits, as the benchmark's seeds are


def tiny_spec(name: str) -> harness.CellSpec:
    spec = harness.find_cell(name)
    cfg = copy.deepcopy(spec.config)
    cfg["model"]["image_size"] = 64
    cfg["language_model"].update(vocab_size=100, dim=32, n_layers=1, n_heads=2, hidden_dim=64,
                                 max_position_embeddings=64)
    if cfg["backbone"]["kind"] == "resnet":
        cfg["model"]["size"] = 18
        cfg["backbone"].update(name="resnet18", block="basic", stage_sizes=[2, 2, 2, 2],
                               expansion=1, out_dim=512)
    else:
        cfg["backbone"]["image_size"] = 64
    mix = dict(spec.mix)
    if mix["driver"] == "train_step":
        mix.update(clips=4, frame_size=64, tokens=8, min_tokens=2, empty_captions=1)
    else:
        mix.update(frame_size=64, frames=min(mix["frames"], 4), pool=min(mix["pool"], 4),
                   sampled=4)
    spec.config, spec.mix = cfg, mix
    return spec
