"""The yardstick's arithmetic for DINOv2 with registers (the configuration's ``backbone``
block of kind ``"dinov2"``), beside `port_bench.flops`, whose peaks and kernel op counts
it uses.

Model FLOPs count two operations a multiply-add of the patch convolution, the layers'
products (Q, K, V, the attention output, ``weights_in`` and ``weights_out``) and
attention's two products over every token: CLS, the registers and the patches.
"""

from __future__ import annotations

from typing import Tuple

from port_bench import flops


def tokens(bb: dict, image_size: int) -> int:
    """Tokens a frame: CLS, the registers and the patches of the grid."""
    return 1 + bb["n_registers"] + (image_size // bb["patch_size"]) ** 2


def forward_macs(bb: dict, image_size: int) -> int:
    """Multiply-adds of one frame through the backbone."""
    d, p, f = bb["dim"], bb["patch_size"], bb["ffn_dim"]
    patches = (image_size // p) ** 2
    t = tokens(bb, image_size)
    layer = t * (4 * d * d + 3 * d * f) + 2 * t * t * d
    return patches * 3 * p * p * d + bb["n_layers"] * layer


def serve_request_flops(cfg: dict, mix: dict) -> int:
    return mix["frames"] * 2 * forward_macs(cfg["backbone"], cfg["model"]["image_size"])


def attention_shape(cfg: dict, frames: int) -> Tuple[int, int, int, int]:
    """``(b, t, heads, d)`` of each layer's attention for `frames` frames."""
    bb = cfg["backbone"]
    return (frames, tokens(bb, cfg["model"]["image_size"]), bb["n_heads"],
            bb["dim"] // bb["n_heads"])


def attention_request_bound_s(cfg: dict, mix: dict, dtype: str) -> float:
    """The least time of a request's attention forward, every layer (`flops.bound_s`)."""
    op = flops.attention_fwd(*attention_shape(cfg, mix["frames"]), dtype)
    return flops.bound_s(*op, dtype)[0] * cfg["backbone"]["n_layers"]
