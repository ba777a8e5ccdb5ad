"""DINOv2 with registers in plain PyTorch: the serving forward of the benchmark's
``dinov2_vitg14_reg`` configuration, written from its published description (Oquab et al.
2023, arXiv:2304.07193; Darcet et al. 2023, arXiv:2309.16588) and HF's
``Dinov2WithRegistersModel``, over a flat dict of tensors under HF's names.

- The patch convolution (bias included), CLS, and the position table for the image's grid:
  kept as it is where the grid has the table's patches and the image is square, else its
  ``s x s`` grid resized in f32 by bicubic interpolation with antialiasing to an explicit
  size (`resize_positions`, inside the forward); positions are added to CLS and patches.
- The register tokens go in after CLS once positions are added (`with_registers`).
- Pre-LN layers: ``h + LayerScale1(attention(norm1(h)))``, then ``h + LayerScale2(
  weights_out(silu(x1) * x2))`` with ``x1, x2`` the two halves of ``weights_in(norm2(h))``
  (`gate`); LayerScale is a per-channel product (`layer_scale`).
- The final LayerNorm; the CLS row is the ``[B, dim]`` embedding.

Departures from the published model: none in the arithmetic. Dropout and stochastic depth
are off, as in inference; HF's training-only ``mask_token`` is not held. Weights are drawn
(`dinov2_specs`), not read from the published checkpoint. Every product goes through an
`Arith`, which fixes its precision (f32 with TF32 off for the reference); nothing here
imports the system under test.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from port_bench.reference import nets, r3m
from port_bench.reference.precision import Arith

Params = Dict[str, torch.Tensor]

# Laws of the drawn weights. A trained model's LayerScale is far from its 1e-5 start
# (per channel, order 0.1 to 1), so that every branch moves the output.
PRODUCT = ("normal", 0.02)
BIAS = ("normal", 0.02)
TOKEN = ("normal", 0.02)
LN_WEIGHT = ("uniform", 0.5, 1.5)
LAYER_SCALE = ("uniform", 0.1, 1.0)


def _linear(prefix: str, cout: int, cin: int) -> List[nets.Spec]:
    return [(f"{prefix}.weight", (cout, cin), PRODUCT), (f"{prefix}.bias", (cout,), BIAS)]


def _ln(prefix: str, c: int) -> List[nets.Spec]:
    return [(f"{prefix}.weight", (c,), LN_WEIGHT), (f"{prefix}.bias", (c,), BIAS)]


def dinov2_specs(bb: dict) -> List[nets.Spec]:
    """``(name, shape, law)`` of every tensor of the backbone `bb` (the configuration's
    ``backbone`` block), in HF's names."""
    d, p = bb["dim"], bb["patch_size"]
    specs = [
        ("embeddings.cls_token", (1, 1, d), TOKEN),
        ("embeddings.register_tokens", (1, bb["n_registers"], d), TOKEN),
        ("embeddings.position_embeddings", (1, bb["position_grid"] ** 2 + 1, d), TOKEN),
        ("embeddings.patch_embeddings.projection.weight", (d, 3, p, p), PRODUCT),
        ("embeddings.patch_embeddings.projection.bias", (d,), BIAS),
    ]
    for i in range(bb["n_layers"]):
        pre = f"encoder.layer.{i}"
        specs += _ln(f"{pre}.norm1", d)
        for name in ("query", "key", "value"):
            specs += _linear(f"{pre}.attention.attention.{name}", d, d)
        specs += _linear(f"{pre}.attention.output.dense", d, d)
        specs.append((f"{pre}.layer_scale1.lambda1", (d,), LAYER_SCALE))
        specs += _ln(f"{pre}.norm2", d)
        specs += _linear(f"{pre}.mlp.weights_in", 2 * bb["ffn_dim"], d)
        specs += _linear(f"{pre}.mlp.weights_out", d, bb["ffn_dim"])
        specs.append((f"{pre}.layer_scale2.lambda1", (d,), LAYER_SCALE))
    return specs + _ln("layernorm", d)


def resize_positions(table: torch.Tensor, height: int, width: int, patch: int
                     ) -> torch.Tensor:
    """HF's ``interpolate_pos_encoding`` of the ``[1, 1 + s*s, dim]`` table for an image
    of `height` x `width` pixels."""
    n = table.shape[1] - 1
    grid_h, grid_w = height // patch, width // patch
    if grid_h * grid_w == n and height == width:
        return table
    side, dim = int(n ** 0.5), table.shape[-1]
    grid = table[:, 1:].reshape(1, side, side, dim).permute(0, 3, 1, 2)
    grid = F.interpolate(grid.to(torch.float32), size=(grid_h, grid_w), mode="bicubic",
                         align_corners=False, antialias=True).to(table.dtype)
    grid = grid.permute(0, 2, 3, 1).reshape(1, grid_h * grid_w, dim)
    return torch.cat([table[:, :1], grid], dim=1)


def with_registers(h: torch.Tensor, registers: torch.Tensor) -> torch.Tensor:
    """``[CLS, registers, patches]`` from ``[CLS, patches]``."""
    return torch.cat([h[:, :1], registers.expand(h.shape[0], -1, -1), h[:, 1:]], dim=1)


def layer_scale(branch: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return branch * scale


def gate(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    return F.silu(x1) * x2


def forward(p: Params, x: torch.Tensor, bb: dict, arith: Arith) -> torch.Tensor:
    """NCHW normalised images -> the ``[B, dim]`` CLS embedding."""
    eps, patch = bb["layer_norm_eps"], bb["patch_size"]
    patches = arith.conv(x, p["embeddings.patch_embeddings.projection.weight"],
                         p["embeddings.patch_embeddings.projection.bias"], stride=patch)
    tokens = patches.flatten(2).transpose(1, 2)
    cls = p["embeddings.cls_token"].expand(x.shape[0], -1, -1)
    h = torch.cat([cls, tokens], dim=1) + resize_positions(
        p["embeddings.position_embeddings"], x.shape[2], x.shape[3], patch)
    h = with_registers(h, p["embeddings.register_tokens"])
    for i in range(bb["n_layers"]):
        pre = f"encoder.layer.{i}"
        y = nets._ln(p, f"{pre}.norm1", h, eps)
        att = f"{pre}.attention.attention"
        ctx = nets._attention(arith, nets._lin(arith, p, f"{att}.query", y),
                              nets._lin(arith, p, f"{att}.key", y),
                              nets._lin(arith, p, f"{att}.value", y), bb["n_heads"])
        y = nets._lin(arith, p, f"{pre}.attention.output.dense", ctx)
        h = h + layer_scale(y, p[f"{pre}.layer_scale1.lambda1"])
        y = nets._lin(arith, p, f"{pre}.mlp.weights_in", nets._ln(p, f"{pre}.norm2", h, eps))
        y = nets._lin(arith, p, f"{pre}.mlp.weights_out", gate(*y.chunk(2, dim=-1)))
        h = h + layer_scale(y, p[f"{pre}.layer_scale2.lambda1"])
    return nets._ln(p, "layernorm", h, eps)[:, 0]


def serve(cfg: dict, p: Params, frames: torch.Tensor, arith: Arith) -> torch.Tensor:
    """``[N, 3, S, S]`` uint8 frames at the crop size -> ``[N, dim]`` embeddings: /255,
    normalised with the configuration's statistics, then `forward`."""
    bb = cfg["backbone"]
    with torch.no_grad(), arith.scope():
        x = r3m.normalize(frames.to(torch.float32) / 255.0, bb["norm_mean"], bb["norm_std"])
        return forward(p, x, bb, arith)
