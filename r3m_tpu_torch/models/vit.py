"""ViT-B/32 visual encoder, the port of ``r3m_tpu/models/vit.py``.

The reference's ``size == 0`` backbone is HF ``google/vit-base-patch32-224-in21k``; `ViT`
is an ``nn.Module`` with HF ``ViTModel`` key names, so the reference's ``convnet.*``
entries load as they are. The forward follows ``vit_b32_apply``: 32x32/32 patch conv,
CLS, learned position embeddings, pre-LN layers (exact GELU, LN eps 1e-12), final LN and
the tanh pooler on CLS, which gives the [B, 768] embedding. Attention goes through
`r3m_tpu_torch.ops.attention.fused_attention`: kernel K3 forward and, when the forward is
differentiated (training), kernel K4 backward, as the JAX training step routes it
(``r3m_tpu/models/r3m.py:123``, "auto" resolves to the kernel for training).
"""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.nn.functional as F
from torch import nn

from r3m_tpu_torch.models.layers import dense, layer_norm
from r3m_tpu_torch.ops.attention import fused_attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 32
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    hidden_dim: int = 3072
    layer_norm_eps: float = 1e-12


B32 = ViTConfig()


def _node(**children) -> nn.Module:
    """An empty module holding `children`: it only gives the state dict HF's names."""
    m = nn.Module()
    for name, child in children.items():
        setattr(m, name, child)
    return m


def _linear(cin: int, cout: int) -> nn.Linear:
    m = nn.Linear(cin, cout)
    nn.init.normal_(m.weight, std=0.02)
    nn.init.zeros_(m.bias)
    return m


class ViT(nn.Module):
    """HF ``ViTModel`` layout; weights drawn N(0, 0.02) from torch's global generator."""

    def __init__(self, cfg: ViTConfig = B32):
        super().__init__()
        self.cfg = cfg
        n_tokens = (cfg.image_size // cfg.patch_size) ** 2 + 1
        projection = nn.Conv2d(3, cfg.dim, cfg.patch_size, stride=cfg.patch_size)
        nn.init.normal_(projection.weight, std=0.02)
        nn.init.zeros_(projection.bias)
        self.embeddings = _node(
            cls_token=nn.Parameter(torch.randn(1, 1, cfg.dim) * 0.02),
            position_embeddings=nn.Parameter(torch.randn(1, n_tokens, cfg.dim) * 0.02),
            patch_embeddings=_node(projection=projection),
        )
        layers = []
        for _ in range(cfg.n_layers):
            layers.append(
                _node(
                    layernorm_before=nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps),
                    attention=_node(
                        attention=_node(
                            query=_linear(cfg.dim, cfg.dim),
                            key=_linear(cfg.dim, cfg.dim),
                            value=_linear(cfg.dim, cfg.dim),
                        ),
                        output=_node(dense=_linear(cfg.dim, cfg.dim)),
                    ),
                    layernorm_after=nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps),
                    intermediate=_node(dense=_linear(cfg.dim, cfg.hidden_dim)),
                    output=_node(dense=_linear(cfg.hidden_dim, cfg.dim)),
                )
            )
        self.encoder = _node(layer=nn.ModuleList(layers))
        self.layernorm = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)
        self.pooler = _node(dense=_linear(cfg.dim, cfg.dim))

    def forward(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        """NCHW normalized images -> ``[B, dim]`` f32 pooled embedding.

        `compute_dtype=torch.bfloat16` runs the products and attention in bf16;
        parameters stay f32, LayerNorm statistics and softmax stay f32. The same forward
        serves and trains: every op is differentiable.
        """
        cfg = self.cfg
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        b = x.shape[0]
        emb = self.embeddings
        proj = emb.patch_embeddings.projection
        patches = F.conv2d(x, proj.weight.to(x.dtype), stride=cfg.patch_size)
        patches = patches + proj.bias.to(x.dtype)[:, None, None]
        tokens = patches.flatten(2).transpose(1, 2)  # row-major patch order (HF)
        cls = emb.cls_token.to(x.dtype).expand(b, 1, cfg.dim)
        h = torch.cat([cls, tokens], dim=1) + emb.position_embeddings.to(x.dtype)

        def lin(m: nn.Linear, y):
            return dense(y, m.weight, m.bias)

        def ln(m: nn.LayerNorm, y):
            return layer_norm(y, m.weight, m.bias, cfg.layer_norm_eps)

        for layer in self.encoder.layer:
            y = ln(layer.layernorm_before, h)
            att = layer.attention.attention
            ctx = fused_attention(
                lin(att.query, y), lin(att.key, y), lin(att.value, y), cfg.n_heads
            )
            h = h + lin(layer.attention.output.dense, ctx)
            y = ln(layer.layernorm_after, h)
            y = F.gelu(lin(layer.intermediate.dense, y))
            h = h + lin(layer.output.dense, y)

        h = ln(self.layernorm, h)
        pooled = torch.tanh(lin(self.pooler.dense, h[:, 0]))
        return pooled.to(torch.float32)


def vit_config_from_state(sd) -> ViTConfig:
    """Infer the ViTConfig from an HF ViTModel state dict.

    Shapes fix everything except `n_heads`, which no parameter shape shows; B32's 12
    heads are assumed for dim 768 and ``dim // 64`` (the HF family ratio) otherwise.
    """
    layer_ids = [
        int(m.group(1))
        for k in sd
        for m in [re.match(r"encoder\.layer\.(\d+)\.", k)]
        if m
    ]
    if not layer_ids:
        raise ValueError(
            "state dict has no encoder.layer.* keys — expected an HF "
            "ViTModel layout (a truncated or differently-prefixed save?)"
        )
    n_layers = 1 + max(layer_ids)
    w = sd["embeddings.patch_embeddings.projection.weight"]  # OIHW
    dim, patch = int(w.shape[0]), int(w.shape[2])
    hidden = int(sd["encoder.layer.0.intermediate.dense.weight"].shape[0])
    n_tokens = int(sd["embeddings.position_embeddings"].shape[1])
    side = int(round((n_tokens - 1) ** 0.5))
    return ViTConfig(
        image_size=side * patch,
        patch_size=patch,
        dim=dim,
        n_layers=n_layers,
        n_heads=12 if dim == 768 else max(1, dim // 64),
        hidden_dim=hidden,
    )


def require_b32_geometry(cfg: ViTConfig) -> None:
    """Reject non-ViT-B/32 geometries: the reference's only ViT (models_r3m.py:52-56),
    and the geometry the `n_heads` guess above is known to hold for."""
    geometry = (cfg.patch_size, cfg.dim, cfg.n_layers, cfg.hidden_dim)
    if geometry != (B32.patch_size, B32.dim, B32.n_layers, B32.hidden_dim):
        raise ValueError(
            "size==0 checkpoints must be ViT-B/32 (the reference's only "
            f"ViT, models_r3m.py:52-56); found patch/dim/layers/ffn = {geometry}"
        )
