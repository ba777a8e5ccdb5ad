"""DINOv2 with registers (Oquab et al. 2023, arXiv:2304.07193; Darcet et al. 2023,
arXiv:2309.16588), a frozen visual encoder served through `R3MEncoder`.

`Dinov2` is an ``nn.Module`` with HF ``Dinov2WithRegistersModel`` key names, so an HF
state dict loads as it is (its training-only ``embeddings.mask_token`` is accepted and
dropped). The forward follows HF's: the patch convolution; CLS; the position table,
resized to the request's grid by HF's rule (f32 bicubic with antialiasing to an explicit
size, kept as it is where the grid is the table's own and the image square) in every
forward (`Dinov2.positions`); the register tokens after CLS, once positions are added;
pre-LN layers whose attention and SwiGLU branches (``silu(x1) * x2`` over the two halves of
``weights_in``) are each scaled per channel by their LayerScale before the residual add;
the final LayerNorm and the CLS row, the ``[B, dim]`` embedding.

The arithmetic is the ViT's (`r3m_tpu_torch.models.vit`): f32 LayerNorm statistics,
parameters kept in f32 and cast to the compute dtype on use, products with f32 results
(`r3m_tpu_torch.models.layers.dense`), attention through kernel K3
(`r3m_tpu_torch.ops.attention.fused_attention`). DINOv2-g/14 at 224 px has 1 + 4 + 256 =
261 tokens a frame, which K3 takes in key tiles.
"""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.nn.functional as F
from torch import nn

from r3m_tpu_torch.models.layers import dense, layer_norm
from r3m_tpu_torch.models.vit import _linear, _node
from r3m_tpu_torch.ops.attention import fused_attention
from r3m_tpu_torch.utils.profiling import LAYERSCALE, SWIGLU_GATE, span

NAME = "dinov2_vitg14_reg"  # the `R3MConfig.size` that names this backbone
HEAD_DIM = 64  # every published DINOv2 has heads of 64; no parameter's shape shows it


@dataclasses.dataclass(frozen=True)
class Dinov2Config:
    patch_size: int = 14
    dim: int = 1536
    n_layers: int = 40
    n_heads: int = 24
    ffn_dim: int = 4096  # the gate's width: ``weights_in`` is [2 * ffn_dim, dim]
    n_registers: int = 4
    grid: int = 37  # the position table's side: 37 * 37 + 1 = 1370 positions (518 px)
    layer_norm_eps: float = 1e-6


G14_REG = Dinov2Config()  # ``facebook/dinov2-with-registers-giant``, 1.13 B parameters


def _layer_scale(dim: int) -> nn.Module:
    return _node(lambda1=nn.Parameter(torch.ones(dim)))


def resize_positions(table: torch.Tensor, grid_h: int, grid_w: int, square: bool
                     ) -> torch.Tensor:
    """HF's ``interpolate_pos_encoding``: the ``[1, 1 + n, dim]`` table (CLS first, then
    an ``s x s`` grid, row-major) for a grid of `grid_h` x `grid_w` patches, in f32. The
    table is kept as it is where the grid has its ``n`` patches and the image is
    `square`; otherwise its grid is resized bicubically with antialiasing."""
    n = table.shape[1] - 1
    if grid_h * grid_w == n and square:
        return table.to(torch.float32)
    side, dim = int(n ** 0.5), table.shape[-1]
    grid = table[:, 1:].to(torch.float32).reshape(1, side, side, dim).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(grid_h, grid_w), mode="bicubic", align_corners=False,
                         antialias=True)
    grid = grid.permute(0, 2, 3, 1).reshape(1, grid_h * grid_w, dim)
    return torch.cat([table[:, :1].to(torch.float32), grid], dim=1)


class Dinov2(nn.Module):
    """HF ``Dinov2WithRegistersModel`` layout. Fresh weights: products N(0, 0.02) with
    zero biases, CLS, registers and positions N(0, 0.02), LayerScale 1, from torch's
    global generator.
    """

    def __init__(self, cfg: Dinov2Config = G14_REG):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        projection = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size)
        nn.init.normal_(projection.weight, std=0.02)
        nn.init.zeros_(projection.bias)
        self.embeddings = _node(
            cls_token=nn.Parameter(torch.randn(1, 1, d) * 0.02),
            register_tokens=nn.Parameter(torch.randn(1, cfg.n_registers, d) * 0.02),
            position_embeddings=nn.Parameter(torch.randn(1, cfg.grid ** 2 + 1, d) * 0.02),
            patch_embeddings=_node(projection=projection),
        )
        layers = []
        for _ in range(cfg.n_layers):
            layers.append(_node(
                norm1=nn.LayerNorm(d, eps=cfg.layer_norm_eps),
                attention=_node(
                    attention=_node(query=_linear(d, d), key=_linear(d, d),
                                    value=_linear(d, d)),
                    output=_node(dense=_linear(d, d)),
                ),
                layer_scale1=_layer_scale(d),
                norm2=nn.LayerNorm(d, eps=cfg.layer_norm_eps),
                mlp=_node(weights_in=_linear(d, 2 * cfg.ffn_dim),
                          weights_out=_linear(cfg.ffn_dim, d)),
                layer_scale2=_layer_scale(d),
            ))
        self.encoder = _node(layer=nn.ModuleList(layers))
        self.layernorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.register_load_state_dict_pre_hook(_drop_mask_token)

    @property
    def out_dim(self) -> int:
        return self.cfg.dim

    def positions(self, grid_h: int, grid_w: int, square: bool) -> torch.Tensor:
        """`resize_positions` of the position table, computed afresh in every call."""
        return resize_positions(self.embeddings.position_embeddings, grid_h, grid_w, square)

    def forward(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        """NCHW normalized images -> the ``[B, dim]`` f32 CLS embedding.

        `compute_dtype=torch.bfloat16` runs the products, attention and the residual
        stream in bf16; parameters stay f32, LayerNorm statistics and softmax f32.
        """
        cfg = self.cfg
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        dt = x.dtype
        b, _, height, width = x.shape
        emb = self.embeddings
        proj = emb.patch_embeddings.projection
        patches = F.conv2d(x, proj.weight.to(dt), stride=cfg.patch_size)
        grid_h, grid_w = patches.shape[-2:]
        patches = patches + proj.bias.to(dt)[:, None, None]
        tokens = patches.flatten(2).transpose(1, 2)  # row-major patch order (HF)
        pos = self.positions(grid_h, grid_w, height == width)
        cls = (emb.cls_token + pos[:, :1]).to(dt).expand(b, 1, cfg.dim)
        registers = emb.register_tokens.to(dt).expand(b, cfg.n_registers, cfg.dim)
        h = torch.cat([cls, registers, tokens + pos[:, 1:].to(dt)], dim=1)

        def lin(m: nn.Linear, y):
            return dense(y, m.weight, m.bias)

        def ln(m: nn.LayerNorm, y):
            return layer_norm(y, m.weight, m.bias, cfg.layer_norm_eps)

        for layer in self.encoder.layer:
            y = ln(layer.norm1, h)
            att = layer.attention.attention
            ctx = fused_attention(lin(att.query, y), lin(att.key, y), lin(att.value, y),
                                  cfg.n_heads)
            h = _scaled_add(h, lin(layer.attention.output.dense, ctx),
                            layer.layer_scale1.lambda1)
            y = _swiglu(lin(layer.mlp.weights_in, ln(layer.norm2, h)))
            h = _scaled_add(h, lin(layer.mlp.weights_out, y), layer.layer_scale2.lambda1)

        # LayerNorm is per token, so the final one runs on the CLS row alone
        return ln(self.layernorm, h[:, 0]).to(torch.float32)


def _scaled_add(h: torch.Tensor, branch: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``h + branch * scale``, the LayerScale and the residual add in one pass."""
    with span(LAYERSCALE):
        return torch.addcmul(h, branch, scale.to(h.dtype))


def _swiglu(y: torch.Tensor) -> torch.Tensor:
    """``silu(x1) * x2`` over the two halves of `y`'s last axis."""
    with span(SWIGLU_GATE):
        x1, x2 = y.chunk(2, dim=-1)
        return F.silu(x1) * x2


def _drop_mask_token(module, state_dict, prefix, *args) -> None:
    state_dict.pop(prefix + "embeddings.mask_token", None)


def dinov2_config_from_state(sd) -> Dinov2Config:
    """The `Dinov2Config` of an HF ``Dinov2WithRegistersModel`` state dict. Shapes fix
    every width but the heads, which are `HEAD_DIM` wide in every published DINOv2."""
    layer_ids = {int(m.group(1)) for k in sd for m in [re.match(r"encoder\.layer\.(\d+)\.", k)]
                 if m}
    if not layer_ids or "embeddings.register_tokens" not in sd:
        raise ValueError("expected an HF Dinov2WithRegistersModel state dict "
                         "(embeddings.register_tokens, encoder.layer.*)")
    if "encoder.layer.0.mlp.weights_in.weight" not in sd:
        # ViT-S/B/L with registers carry a plain MLP (mlp.fc1, mlp.fc2); only ViT-g/14's
        # is the SwiGLU this module runs
        raise ValueError("expected DINOv2's SwiGLU FFN (encoder.layer.*.mlp.weights_in, "
                         "mlp.weights_out), as in dinov2_vitg14_reg; this state dict has "
                         "another MLP: " + ", ".join(sorted(
                             k for k in sd if k.startswith("encoder.layer.0.mlp."))))
    w = sd["embeddings.patch_embeddings.projection.weight"]  # OIHW
    dim = int(w.shape[0])
    if dim % HEAD_DIM:
        raise ValueError(f"DINOv2 widths are multiples of its {HEAD_DIM}-wide heads; "
                         f"got {dim}")
    n_positions = int(sd["embeddings.position_embeddings"].shape[1]) - 1
    return Dinov2Config(
        patch_size=int(w.shape[2]),
        dim=dim,
        n_layers=1 + max(layer_ids),
        n_heads=dim // HEAD_DIM,
        ffn_dim=int(sd["encoder.layer.0.mlp.weights_out.weight"].shape[1]),
        n_registers=int(sd["embeddings.register_tokens"].shape[1]),
        grid=int(round(n_positions ** 0.5)),
    )


def dinov2_from_state(sd) -> Dinov2:
    """A `Dinov2` that holds `sd`'s own tensors (no fresh weights are drawn first)."""
    with torch.device("meta"):
        model = Dinov2(dinov2_config_from_state(sd))
    # detached, so that the caller's Parameters are not shared with this module
    model.load_state_dict({k: v.detach() for k, v in sd.items()}, assign=True)
    return model
