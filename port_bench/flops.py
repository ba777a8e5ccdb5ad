"""The yardstick's arithmetic: the card's peaks, each configuration's model FLOPs, and
each kernel op's bytes and FLOPs, all from shapes.

Model FLOPs count two operations a multiply-add of the convolutions and products the
model needs; a trained step counts the trained networks' forward three times (forward
and backward), the frozen DistilBERT's once, and no recomputation. An op's bytes are
each input byte read once and each output byte written once; its bound is the larger of
bytes over the memory bandwidth and FLOPs over the peak of its dtype.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2, "float32": 4}


def _conv(cin: int, cout: int, k: int, hout: int) -> int:
    return cin * cout * k * k * hout * hout


def resnet_forward_macs(backbone: dict, image_size: int) -> int:
    """Multiply-adds of one frame through the convolutions of a ResNet (no fc head)."""
    width, exp = backbone["width"], backbone["expansion"]
    h = (image_size + 1) // 2  # conv1, stride 2
    macs = _conv(3, width, 7, h)
    h = (h + 1) // 2  # the stem pool
    cin = width
    for stage, n in enumerate(backbone["stage_sizes"]):
        planes = width * 2 ** stage
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 else 1
            hout = (h + stride - 1) // stride
            cout = planes * exp
            if backbone["block"] == "basic":
                macs += _conv(cin, planes, 3, hout) + _conv(planes, planes, 3, hout)
            else:
                macs += (_conv(cin, planes, 1, h) + _conv(planes, planes, 3, hout)
                         + _conv(planes, cout, 1, hout))
            if stride != 1 or cin != cout:
                macs += _conv(cin, cout, 1, hout)
            cin, h = cout, hout
    return macs


def vit_forward_macs(vit: dict) -> int:
    """Multiply-adds of one frame through a ViT: patch embedding, the layers' products
    (Q, K, V, output, MLP) and attention's two products, and the pooler."""
    d, p = vit["dim"], vit["patch_size"]
    patches = (vit["image_size"] // p) ** 2
    t = patches + 1
    layer = t * (4 * d * d + 2 * d * vit["mlp_dim"]) + 2 * t * t * d
    return patches * 3 * p * p * d + vit["n_layers"] * layer + d * d


def bert_forward_macs(bert: dict, tokens: int) -> int:
    """Multiply-adds of one caption of `tokens` tokens through DistilBERT."""
    d = bert["dim"]
    layer = tokens * (4 * d * d + 2 * d * bert["hidden_dim"]) + 2 * tokens * tokens * d
    return bert["n_layers"] * layer


def reward_forward_macs(im_dim: int, hidden: int, lang_dim: int) -> int:
    return (2 * im_dim + lang_dim) * hidden + 3 * hidden * hidden + hidden


def encoder_forward_flops(cfg: dict) -> int:
    """FLOPs of one frame through the configuration's backbone."""
    bb = cfg["backbone"]
    if bb["kind"] == "vit":
        return 2 * vit_forward_macs(bb)
    return 2 * resnet_forward_macs(bb, cfg["model"]["image_size"])


def train_step_flops(cfg: dict, mix: dict) -> Dict[str, int]:
    """Model FLOPs of one step, by part: the encoder and the reward head forward and
    backward, DistilBERT forward."""
    model, clips = cfg["model"], mix["clips"]
    out = {"encoder": 3 * clips * mix["frames"] * encoder_forward_flops(cfg), "language": 0,
           "reward": 0}
    if model["langweight"] > 0:
        out["language"] = 2 * clips * bert_forward_macs(cfg["language_model"], mix["tokens"])
        pairs = (6 + 3 * model["num_negatives"]) * clips
        out["reward"] = 3 * 2 * pairs * reward_forward_macs(
            cfg["backbone"]["out_dim"], model["hidden_dim"], cfg["language_model"]["dim"])
    return out


def serve_request_flops(cfg: dict, mix: dict) -> int:
    return mix["frames"] * encoder_forward_flops(cfg)


def bound_s(nbytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    """The least time of an op, and what bounds it ("bytes" or "flops")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_flops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "flops")


# --- kernel ops -------------------------------------------------------------------------

def pooled(n: int) -> int:
    """Output edge of a 3x3 stride-2 pool with padding 1."""
    return (n - 1) // 2 + 1


def maxpool_fwd(n: int, h: int, w: int, c: int, dtype: str, argmax: bool) -> Tuple[int, int]:
    """The stem max-pool (3x3, stride 2, padding 1) of NHWC ``[n, h, w, c]``: (bytes,
    FLOPs); with `argmax` it also writes the int8 window index a training step keeps."""
    e = BYTES[dtype]
    out = n * pooled(h) * pooled(w) * c
    return n * h * w * c * e + out * e + (out if argmax else 0), 8 * out


def maxpool_bwd(n: int, h: int, w: int, c: int, dtype: str) -> Tuple[int, int]:
    """Its gradient: reads dy and the int8 index, writes dx ``[n, h, w, c]``."""
    e = BYTES[dtype]
    out = n * pooled(h) * pooled(w) * c
    return out * e + out + n * h * w * c * e, out


def attention_fwd(b: int, t: int, heads: int, d: int, dtype: str) -> Tuple[int, int]:
    """softmax(Q K^T / sqrt(d)) V over packed ``[b, t, heads*d]``: reads Q, K, V, writes
    the output; two products a head."""
    return 4 * b * t * heads * d * BYTES[dtype], 4 * b * heads * t * t * d


def attention_bwd(b: int, t: int, heads: int, d: int, dtype: str) -> Tuple[int, int]:
    """Its gradient: reads Q, K, V and dO, writes dQ, dK, dV; five products a head (the
    scores again, dV, dP, dQ, dK)."""
    return 7 * b * t * heads * d * BYTES[dtype], 10 * b * heads * t * t * d


def stem_pool_input(cfg: dict, frames: int) -> Tuple[int, int, int, int]:
    """NHWC shape the ResNet stem pool reads for `frames` frames."""
    h = (cfg["model"]["image_size"] + 1) // 2
    return frames, h, h, cfg["backbone"]["width"]


def vit_attention_shape(cfg: dict, frames: int) -> Tuple[int, int, int, int]:
    """``(b, t, heads, d)`` of each ViT layer's attention for `frames` frames."""
    bb = cfg["backbone"]
    t = (bb["image_size"] // bb["patch_size"]) ** 2 + 1
    return frames, t, bb["n_heads"], bb["dim"] // bb["n_heads"]
