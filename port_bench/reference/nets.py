"""Plain PyTorch forwards of the networks R3M runs, written from their published
descriptions, over a flat dict of tensors under the reference checkpoints' names.

- ResNet-18/34/50 (He et al. 2015, torchvision v1.5 layout: the stride on the 3x3 of a
  bottleneck), without the ``fc`` head: the ``[B, out]`` mean of the last stage.
- ViT (Dosovitskiy et al. 2020, HF ``ViTModel`` names): patch convolution, CLS token,
  learned positions, pre-LN layers, exact GELU, final LN, the tanh pooler on CLS.
- DistilBERT (Sanh et al. 2019, HF ``DistilBertModel`` names): post-LN layers, exact
  GELU, padded keys masked, and R3M's sentence embedding, the plain mean over every
  token of the padded caption.
- R3M's language-reward head: a five-layer ReLU MLP over ``[e0, eg, lang]``.

Each ``*_specs`` lists ``(name, shape, law)`` for every tensor, with the law the weights
are drawn from (`port_bench.weights`). Every product goes through an `Arith`, which fixes
its precision. Nothing here imports the port.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.precision import Arith

Params = Dict[str, torch.Tensor]
Spec = Tuple[str, Tuple[int, ...], tuple]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


# --- ResNet ---------------------------------------------------------------------------

def _resnet_layout(backbone: dict):
    """``[(prefix, cin, planes, stride, has_downsample)]`` for every block."""
    expansion = backbone["expansion"]
    width = backbone["width"]
    cin, blocks = width, []
    for stage, n in enumerate(backbone["stage_sizes"]):
        planes = width * 2 ** stage
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 else 1
            cout = planes * expansion
            blocks.append((f"layer{stage + 1}.{b}", cin, planes, stride,
                           stride != 1 or cin != cout))
            cin = cout
    return blocks


def _bn_specs(prefix: str, c: int, serving: bool) -> List[Spec]:
    """A trained checkpoint's BatchNorm (`serving`) holds arbitrary statistics and an
    affine map; a fresh one to train holds torchvision's init."""
    if serving:
        laws = [("uniform", 0.5, 1.5), ("normal", 0.1), ("normal", 0.5), ("uniform", 0.5, 2.0)]
    else:
        laws = [("const", 1.0), ("const", 0.0), ("const", 0.0), ("const", 1.0)]
    names = ("weight", "bias", "running_mean", "running_var")
    out = [(f"{prefix}.{n}", (c,), law) for n, law in zip(names, laws)]
    return out + [(f"{prefix}.num_batches_tracked", (), ("count",))]


def _conv_spec(name: str, cout: int, cin: int, k: int) -> Spec:
    # Kaiming normal over the fan-out, as torchvision draws a ResNet
    return (name, (cout, cin, k, k), ("normal", math.sqrt(2.0 / (cout * k * k))))


def resnet_specs(backbone: dict, serving: bool = False) -> List[Spec]:
    width, basic = backbone["width"], backbone["block"] == "basic"
    specs = [_conv_spec("conv1.weight", width, 3, 7)] + _bn_specs("bn1", width, serving)
    for prefix, cin, planes, stride, down in _resnet_layout(backbone):
        cout = planes * backbone["expansion"]
        if basic:
            convs = [(planes, cin, 3), (planes, planes, 3)]
        else:
            convs = [(planes, cin, 1), (planes, planes, 3), (cout, planes, 1)]
        for j, (co, ci, k) in enumerate(convs, start=1):
            specs.append(_conv_spec(f"{prefix}.conv{j}.weight", co, ci, k))
            specs += _bn_specs(f"{prefix}.bn{j}", co, serving)
        if down:
            specs.append(_conv_spec(f"{prefix}.downsample.0.weight", cout, cin, 1))
            specs += _bn_specs(f"{prefix}.downsample.1", cout, serving)
    return specs


def _bn(p: Params, prefix: str, y: torch.Tensor, train: bool) -> torch.Tensor:
    return F.batch_norm(y, p[f"{prefix}.running_mean"], p[f"{prefix}.running_var"],
                        p[f"{prefix}.weight"], p[f"{prefix}.bias"], training=train,
                        momentum=BN_MOMENTUM, eps=BN_EPS)


def resnet_forward(p: Params, x: torch.Tensor, backbone: dict, train: bool,
                   arith: Arith) -> torch.Tensor:
    """NCHW normalised images -> ``[B, out]``. ``train`` normalises with the batch's
    statistics and updates the running ones in place."""
    basic = backbone["block"] == "basic"
    y = F.relu(_bn(p, "bn1", arith.conv(x, p["conv1.weight"], stride=2, padding=3), train))
    y = F.max_pool2d(y, kernel_size=3, stride=2, padding=1)
    for prefix, _, _, stride, down in _resnet_layout(backbone):
        if basic:
            convs = [(stride, 1), (1, 1)]
        else:
            convs = [(1, 0), (stride, 1), (1, 0)]
        h = y
        for j, (s, pad) in enumerate(convs, start=1):
            h = arith.conv(h, p[f"{prefix}.conv{j}.weight"], stride=s, padding=pad)
            h = _bn(p, f"{prefix}.bn{j}", h, train)
            if j < len(convs):
                h = F.relu(h)
        shortcut = y
        if down:
            shortcut = _bn(p, f"{prefix}.downsample.1",
                           arith.conv(y, p[f"{prefix}.downsample.0.weight"], stride=stride),
                           train)
        y = F.relu(h + shortcut)
    return y.mean(dim=(2, 3))


# --- ViT ------------------------------------------------------------------------------

def _linear_specs(prefix: str, cout: int, cin: int) -> List[Spec]:
    return [(f"{prefix}.weight", (cout, cin), ("normal", 0.02)),
            (f"{prefix}.bias", (cout,), ("const", 0.0))]


def _ln_specs(prefix: str, c: int) -> List[Spec]:
    return [(f"{prefix}.weight", (c,), ("const", 1.0)), (f"{prefix}.bias", (c,), ("const", 0.0))]


def vit_specs(vit: dict) -> List[Spec]:
    d, patch = vit["dim"], vit["patch_size"]
    tokens = (vit["image_size"] // patch) ** 2 + 1
    specs = [
        ("embeddings.cls_token", (1, 1, d), ("normal", 0.02)),
        ("embeddings.position_embeddings", (1, tokens, d), ("normal", 0.02)),
        ("embeddings.patch_embeddings.projection.weight", (d, 3, patch, patch),
         ("normal", 0.02)),
        ("embeddings.patch_embeddings.projection.bias", (d,), ("const", 0.0)),
    ]
    for i in range(vit["n_layers"]):
        pre = f"encoder.layer.{i}"
        specs += _ln_specs(f"{pre}.layernorm_before", d)
        for name in ("query", "key", "value"):
            specs += _linear_specs(f"{pre}.attention.attention.{name}", d, d)
        specs += _linear_specs(f"{pre}.attention.output.dense", d, d)
        specs += _ln_specs(f"{pre}.layernorm_after", d)
        specs += _linear_specs(f"{pre}.intermediate.dense", vit["mlp_dim"], d)
        specs += _linear_specs(f"{pre}.output.dense", d, vit["mlp_dim"])
    return specs + _ln_specs("layernorm", d) + _linear_specs("pooler.dense", d, d)


def _attention(arith: Arith, q, k, v, heads: int, mask=None) -> torch.Tensor:
    """softmax(Q K^T / sqrt(d) + mask) V per head over ``[B, T, H*d]``."""
    b, t, hd = q.shape
    d = hd // heads

    def split(x):
        return x.reshape(b, t, heads, d).transpose(1, 2)

    s = arith.matmul(split(q), split(k).transpose(-1, -2)) / math.sqrt(d)
    if mask is not None:
        s = s + mask
    ctx = arith.matmul(torch.softmax(s, dim=-1), split(v))
    return ctx.transpose(1, 2).reshape(b, t, hd)


def _lin(arith: Arith, p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    return arith.linear(x, p[f"{prefix}.weight"], p[f"{prefix}.bias"])


def _ln(p: Params, prefix: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{prefix}.weight"], p[f"{prefix}.bias"], eps)


def vit_forward(p: Params, x: torch.Tensor, vit: dict, arith: Arith) -> torch.Tensor:
    """NCHW normalised images -> the pooled ``[B, dim]`` embedding."""
    eps = vit["layer_norm_eps"]
    patches = arith.conv(x, p["embeddings.patch_embeddings.projection.weight"],
                         p["embeddings.patch_embeddings.projection.bias"],
                         stride=vit["patch_size"])
    tokens = patches.flatten(2).transpose(1, 2)
    cls = p["embeddings.cls_token"].expand(x.shape[0], -1, -1)
    h = torch.cat([cls, tokens], dim=1) + p["embeddings.position_embeddings"]
    for i in range(vit["n_layers"]):
        pre = f"encoder.layer.{i}"
        y = _ln(p, f"{pre}.layernorm_before", h, eps)
        att = f"{pre}.attention.attention"
        ctx = _attention(arith, _lin(arith, p, f"{att}.query", y),
                         _lin(arith, p, f"{att}.key", y), _lin(arith, p, f"{att}.value", y),
                         vit["n_heads"])
        h = h + _lin(arith, p, f"{pre}.attention.output.dense", ctx)
        y = _ln(p, f"{pre}.layernorm_after", h, eps)
        y = F.gelu(_lin(arith, p, f"{pre}.intermediate.dense", y))
        h = h + _lin(arith, p, f"{pre}.output.dense", y)
    h = _ln(p, "layernorm", h, eps)
    return torch.tanh(_lin(arith, p, "pooler.dense", h[:, 0]))


# --- DistilBERT -------------------------------------------------------------------------

def bert_specs(bert: dict) -> List[Spec]:
    d = bert["dim"]
    specs = [
        ("embeddings.word_embeddings.weight", (bert["vocab_size"], d), ("normal", 0.02)),
        ("embeddings.position_embeddings.weight", (bert["max_position_embeddings"], d),
         ("normal", 0.02)),
    ] + _ln_specs("embeddings.LayerNorm", d)
    for i in range(bert["n_layers"]):
        pre = f"transformer.layer.{i}"
        for name in ("q_lin", "k_lin", "v_lin", "out_lin"):
            specs += _linear_specs(f"{pre}.attention.{name}", d, d)
        specs += _ln_specs(f"{pre}.sa_layer_norm", d)
        specs += _linear_specs(f"{pre}.ffn.lin1", bert["hidden_dim"], d)
        specs += _linear_specs(f"{pre}.ffn.lin2", d, bert["hidden_dim"])
        specs += _ln_specs(f"{pre}.output_layer_norm", d)
    return specs


def bert_sentence(p: Params, ids: torch.Tensor, mask: torch.Tensor, bert: dict,
                  arith: Arith) -> torch.Tensor:
    """``[B, T]`` ids and {0, 1} mask -> ``[B, dim]``: the last hidden state averaged over
    all T positions, padding included, as R3M pools it."""
    eps = bert["layer_norm_eps"]
    t = ids.shape[1]
    x = p["embeddings.word_embeddings.weight"][ids]
    x = _ln(p, "embeddings.LayerNorm", x + p["embeddings.position_embeddings.weight"][:t], eps)
    add_mask = torch.zeros(mask.shape, dtype=x.dtype, device=x.device)
    add_mask = add_mask.masked_fill(mask == 0, torch.finfo(x.dtype).min)[:, None, None, :]
    for i in range(bert["n_layers"]):
        pre = f"transformer.layer.{i}"
        att = f"{pre}.attention"
        ctx = _attention(arith, _lin(arith, p, f"{att}.q_lin", x),
                         _lin(arith, p, f"{att}.k_lin", x), _lin(arith, p, f"{att}.v_lin", x),
                         bert["n_heads"], add_mask)
        x = _ln(p, f"{pre}.sa_layer_norm", x + _lin(arith, p, f"{att}.out_lin", ctx), eps)
        h = F.gelu(_lin(arith, p, f"{pre}.ffn.lin1", x))
        x = _ln(p, f"{pre}.output_layer_norm", x + _lin(arith, p, f"{pre}.ffn.lin2", h), eps)
    return x.mean(dim=1)


# --- the language-reward head -----------------------------------------------------------

def reward_specs(im_dim: int, hidden: int, lang_dim: int) -> List[Spec]:
    dims = [2 * im_dim + lang_dim] + [hidden] * 4 + [1]
    specs = []
    for i in range(5):
        bound = 1.0 / math.sqrt(dims[i])  # torch's default Linear draw
        specs += [(f"pred.{2 * i}.weight", (dims[i + 1], dims[i]), ("uniform", -bound, bound)),
                  (f"pred.{2 * i}.bias", (dims[i + 1],), ("uniform", -bound, bound))]
    return specs


def reward_forward(p: Params, e0, eg, lang, arith: Arith) -> torch.Tensor:
    """``[N, D], [N, D], [N, L] -> [N]`` scores."""
    x = torch.cat([e0, eg, lang], dim=-1)
    for i in range(5):
        x = _lin(arith, p, f"pred.{2 * i}", x)
        if i < 4:
            x = F.relu(x)
    return x[:, 0]
