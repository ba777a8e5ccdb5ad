"""R3M model: visual encoder, similarity and language-reward container, the port of
``r3m_tpu/models/r3m.py``.

`R3MConfig` keeps every field of the JAX config and its validation, so configs
round-trip between the two packages. `R3MModel` (made by `r3m_init`) holds the trainable
state: the backbone ``convnet`` with its BatchNorm statistics and, when ``langweight > 0``,
the reward head ``lang_rew``. `r3m_embed` maps images to features in eval or train mode;
`safe_l2_norm` and `sim` are the losses' similarity. `R3MEncoder` is what
`r3m_tpu_torch.load_r3m` returns: NCHW images in [0, 255] in, ``[B, out_dim]`` f32
embeddings out, with BatchNorm folded once for ResNets. Besides R3M's own backbones it
serves DINOv2-g/14 with registers (``size="dinov2_vitg14_reg"``,
`r3m_tpu_torch.models.dinov2`), a frozen encoder that is not trained here.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import warnings
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from r3m_tpu_torch.models import dinov2, graphs
from r3m_tpu_torch.models.language_reward import LanguageReward
from r3m_tpu_torch.models.resnet import (
    ResNet,
    cast_folded,
    fold_batchnorm,
    resnet_apply_folded,
    resnet_out_dim,
)
from r3m_tpu_torch.models.vit import B32, ViT
from r3m_tpu_torch.ops.image import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    VIT_MEAN,
    VIT_STD,
    r3m_preprocess,
)
from r3m_tpu_torch.ops.pool import maxpool_3x3s2_fwd
from r3m_tpu_torch.utils.profiling import (
    ENCODER,
    ENCODER_CHECK,
    ENCODER_EMBED,
    ENCODER_H2D,
    ENCODER_REPLAY,
    span,
)

LANG_DIM = 768  # DistilBERT hidden size (models_language.py:21)


@dataclasses.dataclass(frozen=True)
class R3MConfig:
    """Model/loss configuration; field names and defaults mirror the JAX package's
    `R3MConfig` and the reference's `cfgs/config_rep.yaml` agent block.

    In this package the ViT's attention always runs its fused kernels, so
    `vit_fused_attn` only validates; the port trains with BatchNorm unpacked, so
    `packed_bn` (a TPU memory layout with the same math) is read by nothing.
    """

    size: int = 34  # 18 | 34 | 50 | 0 (ViT-B/32), or the name "dinov2_vitg14_reg"
    hidden_dim: int = 1024
    l2weight: float = 1e-5
    l1weight: float = 1e-5
    langweight: float = 0.0
    tcnweight: float = 1.0
    l2dist: bool = True
    num_negatives: int = 3
    lr: float = 1e-4
    bs: int = 32
    compute_dtype: str = "float32"  # "bfloat16" for max-throughput training
    image_size: int = 224  # training/eval crop size (224 in the reference)
    optimizer: str = "adam"
    weight_decay: float = 0.0  # lars only
    remat: str = "none"
    lang_dim: int = LANG_DIM
    packed_bn: bool = True
    vit_fused_attn: Any = "auto"

    def __post_init__(self):
        if self.backbone != "resnet" and self.remat != "none":
            raise ValueError(
                "remat is a ResNet-only activation-memory lever; "
                f"remat={self.remat!r} has no effect on size="
                + ("0 (ViT-B/32)" if self.size == 0 else f"{self.size} (a transformer)")
            )
        if self.vit_fused_attn not in ("auto", False, True, "batched"):
            raise ValueError(
                "vit_fused_attn must be 'auto', false, true, or 'batched'; "
                f"got {self.vit_fused_attn!r}"
            )
        if self.backbone != "vit" and self.vit_fused_attn not in (False, "auto"):
            raise ValueError(
                "vit_fused_attn is a ViT-only lever; it has no effect on "
                f"size={self.size} ("
                + ("ResNet has no attention)" if self.backbone == "resnet"
                   else "its attention always runs K3)")
            )

    @property
    def backbone(self) -> str:
        """The kind of backbone `size` names: "resnet", "vit" or "dinov2"."""
        if self.size == 0:
            return "vit"
        return "dinov2" if self.size == dinov2.NAME else "resnet"

    @property
    def out_dim(self) -> int:
        """The published backbone's width (a DINOv2 encoder's own is its weights')."""
        if self.backbone == "vit":
            return B32.dim
        if self.backbone == "dinov2":
            return dinov2.G14_REG.dim
        return resnet_out_dim(self.size)

    @property
    def resize_to(self) -> int:
        """Pre-crop resize edge: torchvision's Resize(256)+CenterCrop(224) serving law
        scaled to the configured crop (models_r3m.py:90)."""
        return max(1, round(self.image_size * 256 / 224))

    @property
    def norm_stats(self) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
        if self.backbone == "vit":
            return VIT_MEAN, VIT_STD
        return IMAGENET_MEAN, IMAGENET_STD

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


def build_convnet(cfg: R3MConfig) -> nn.Module:
    """The backbone module `cfg` names, with freshly drawn weights (DINOv2 at its
    published widths)."""
    if cfg.backbone == "dinov2":
        return dinov2.Dinov2()
    if cfg.size == 0:
        if cfg.image_size % B32.patch_size:
            raise ValueError(
                f"ViT-B/32 needs image_size divisible by {B32.patch_size}, "
                f"got {cfg.image_size}"
            )
        return ViT(dataclasses.replace(B32, image_size=cfg.image_size))
    return ResNet(cfg.size)


def _preprocess(cfg: R3MConfig, obs: torch.Tensor) -> torch.Tensor:
    mean, std = cfg.norm_stats
    return r3m_preprocess(obs, mean, std, crop_size=cfg.image_size, resize_to=cfg.resize_to)


class R3MModel(nn.Module):
    """The trainable state of R3M: ``convnet`` (its parameters and BatchNorm statistics)
    and, when ``cfg.langweight > 0``, ``lang_rew``. Parameter names are the reference's
    (``convnet.*``, ``lang_rew.pred.*``), without DataParallel's ``module.``."""

    def __init__(self, cfg: R3MConfig):
        super().__init__()
        self.convnet = build_convnet(cfg)
        self.lang_rew = (
            LanguageReward(cfg.out_dim, cfg.hidden_dim, cfg.lang_dim)
            if cfg.langweight > 0
            else None
        )


def r3m_init(cfg: R3MConfig, seed: int = 0) -> R3MModel:
    """A fresh `R3MModel`, drawn from `seed` without touching torch's global generator."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return R3MModel(cfg)


def r3m_embed(
    cfg: R3MConfig,
    convnet: nn.Module,
    obs: torch.Tensor,
    *,
    train: bool = False,
    prenormalized: bool = False,
    bn_group=None,
) -> torch.Tensor:
    """Images -> embeddings (reference `forward`, models_r3m.py:84-100).

    `obs`: NHWC float/int in [0, 255] (or, with `prenormalized`, encoder-input form, as
    the augmentation emits it). Returns ``[B, out_dim]`` f32. ``train=False`` is the port
    of ``r3m_embed(train=False)``: BatchNorm reads its running statistics, which stay as
    they are. ``train=True``: ResNet BatchNorm uses batch statistics and updates the
    running ones in place; the ViT has no BatchNorm and runs the same forward. With
    `bn_group` (the data-parallel step's process group) ResNet BatchNorm takes its batch
    statistics over every rank's rows. ``cfg.remat="conv_saved"`` trains a ResNet with
    fewer activations kept for the backward (`ResNet._forward_conv_saved`). DINOv2, like
    the ViT, runs one forward in both modes.
    """
    x = obs if prenormalized else _preprocess(cfg, obs)
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    if cfg.backbone != "resnet":
        return convnet(x, compute_dtype=cfg.torch_compute_dtype)
    return convnet(x.to(cfg.torch_compute_dtype), train=train, bn_group=bn_group,
                   remat=cfg.remat)


def safe_l2_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with an exact forward and a zero subgradient where x == 0 (torch's rule,
    which the reference relies on when a shuffled negative meets itself). The double
    `where` keeps the square root away from 0, so no 0/0 reaches the gradient."""
    sq = (x * x).sum(dim=dim)
    is_zero = sq == 0
    return torch.where(is_zero, 0.0, torch.sqrt(torch.where(is_zero, 1.0, sq)))


def sim(cfg: R3MConfig, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """-L2 distance or cosine similarity over the last axis (models_r3m.py:102-107).

    Cosine follows torch 1.7.1, the version the reference pins: dot / max(|a|*|b|, eps),
    the clamp on the norm PRODUCT, so exactly-zero embeddings give 0, not NaN.
    """
    if cfg.l2dist:
        return -safe_l2_norm(a - b, dim=-1)
    dot = (a * b).sum(dim=-1)
    denom = safe_l2_norm(a, dim=-1) * safe_l2_norm(b, dim=-1)
    return dot / torch.clamp(denom, min=1e-8)


def resolve_device(device=None) -> torch.device:
    """``"cuda"`` unless the caller names another device; a CUDA device needs a card.
    A CUDA device without an index resolves to the current one."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "r3m_tpu_torch runs on a CUDA device by default and none is available; "
                "pass device='cpu' to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def full_f32():
    """True f32 convolutions and products (no TF32) for the block; the caller's settings
    are restored after. Parity serving and the f32 train and eval steps run inside it."""
    saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


class R3MEncoder(nn.Module):
    """User-facing inference module returned by `load_r3m`.

    Takes NCHW (torch layout) float/uint8 images in [0, 255], numpy or tensor, any
    spatial size (non-crop-size inputs get Resize(256)+CenterCrop(224)), and returns
    ``[B, out_dim]`` f32 embeddings on its device.

    `state_dict`: the backbone's weights under the reference's torch names (torchvision
    ResNet, HF ViTModel or HF Dinov2WithRegistersModel, without the ``convnet.`` prefix);
    None keeps fresh weights. A DINOv2 encoder takes its widths from the state dict and
    holds its tensors as they are (moved to the device), drawing no fresh weights.
    `precision`: ``"parity"`` (default) is f32 with TF32 off for convolutions and
    products, switched off only while the forward runs. ``"fast"`` folds in f32, runs the
    convolution/product stack in bfloat16 and returns f32.
    `device`: ``"cuda"`` unless given; ``"cpu"`` runs the kernels' plain versions.
    `mesh`: a `r3m_tpu_torch.parallel.mesh.DeviceMesh` serves over several devices (the
    counterpart of the JAX encoder's ``mesh=``): one replica of the serving weights a
    device, made once; a batch, whose size must divide by the mesh's, is split in device
    order, each part's forward issued on its device before any result is read, and the
    embeddings come back on the first device. It replaces `device`.

    On one CUDA device, a ResNet's batches of at most `graphs.MAX_BATCH` frames run as a
    CUDA graph from their second call on: one graph a (shape, dtype, precision) of input,
    at most `graphs.MAX_KEYS` of them, each with its own pool of activations. The call
    still returns a fresh tensor, and a refold (after any change to the weights) drops
    every graph. `graph_captures`, `graph_replays` and `graph_fallbacks` (captures that
    raised, whose shapes then stay eager) count them.
    """

    def __init__(
        self,
        cfg: R3MConfig,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        precision: str = "parity",
        device=None,
        mesh=None,
    ):
        super().__init__()
        if precision not in ("parity", "fast"):
            raise ValueError(f"precision must be 'parity' or 'fast', got {precision!r}")
        if mesh is not None:
            self.devices = tuple(resolve_device(d) for d in mesh.devices)
        else:
            self.devices = (resolve_device(device),)
        self.mesh = mesh
        self.cfg = cfg
        self.precision = precision
        if cfg.backbone == "dinov2" and state_dict is not None:
            convnet = dinov2.dinov2_from_state(state_dict)
        else:
            convnet = build_convnet(cfg)
            if state_dict is not None:
                convnet.load_state_dict(state_dict)
        self.convnet = convnet.to(self.devices[0]).eval()
        self._replicas = None  # the serving weights, one a device: folded trees or ViTs
        self._folded_src = None
        self._graphs = graphs.GraphCache()
        self.graph_captures = self.graph_replays = self.graph_fallbacks = 0

    @property
    def module(self):  # DataParallel-compat alias (the reference accesses .module)
        return self

    @property
    def outdim(self) -> int:
        if self.cfg.backbone == "dinov2":
            return self.convnet.out_dim
        return self.cfg.out_dim

    @property
    def device(self) -> torch.device:
        return next(self.convnet.parameters()).device

    def _weights_stamp(self):
        tensors = (*self.convnet.parameters(), *self.convnet.buffers())
        return tensors, [(t._version, t.data_ptr()) for t in tensors]

    def refold(self):
        """Recompute the serving weights of every device from the current parameters:
        the BN-folded tree of a ResNet, a transformer itself (copied to the other
        devices). Drops every CUDA graph, which read the weights it replaces."""
        self._graphs.clear()
        devices = (self.device,) + self.devices[1:]
        if self.cfg.backbone != "resnet":
            replicas = [self.convnet] + [copy.deepcopy(self.convnet).to(d) for d in devices[1:]]
        else:
            with torch.inference_mode():
                folded = fold_batchnorm(self.convnet)
                if self.precision == "fast":
                    folded = cast_folded(folded, torch.bfloat16)
                replicas = [folded] + [cast_folded(folded, folded["conv1"]["w"].dtype, d)
                                       for d in devices[1:]]
        self._replicas = replicas
        self._folded_src = self._weights_stamp()

    def _stale(self) -> bool:
        # A swapped module, a replaced parameter, an in-place load_state_dict or a move
        # to another device each change an identity, a version counter or an address.
        # The stamp keeps the folded-from tensors alive, so identity checks are safe.
        if self._folded_src is None:
            return True
        tensors, stamp = self._weights_stamp()
        old_tensors, old_stamp = self._folded_src
        return (
            len(tensors) != len(old_tensors)
            or any(a is not b for a, b in zip(tensors, old_tensors))
            or stamp != old_stamp
        )

    def forward(self, obs, num_ims: int = 1, obs_shape=None) -> torch.Tensor:
        """NCHW [0,255] images -> [B, out_dim]. `num_ims`/`obs_shape` are accepted for
        reference-signature compatibility (models_r3m.py:84); shapes are handled
        automatically."""
        with span(ENCODER):
            return self._forward(obs)

    def _forward(self, obs) -> torch.Tensor:
        if not isinstance(obs, torch.Tensor):
            obs = torch.from_numpy(np.asarray(obs))
        if obs.ndim == 3:
            obs = obs[None]
        if obs.ndim != 4 or obs.shape[1] != 3:
            hint = (
                " (input looks channels-last — this API takes torch NCHW layout)"
                if obs.ndim == 4 and obs.shape[-1] == 3
                else ""
            )
            raise ValueError(
                f"expected NCHW [B, 3, H, W] images, got {tuple(obs.shape)}{hint}"
            )
        n = len(self.devices)
        if obs.shape[0] % n:
            raise ValueError(f"batch of {obs.shape[0]} not divisible by the mesh's "
                             f"{n} devices")
        fast = self.precision == "fast"
        precision_scope = contextlib.nullcontext() if fast else full_f32()
        # a transformer's replicas exist only on a mesh of several devices
        replicate = self.cfg.backbone == "resnet" or n > 1
        with span(ENCODER_CHECK):
            if replicate and self._stale():
                self.refold()
        per = obs.shape[0] // n
        with torch.inference_mode(), precision_scope:
            # a graph reads weights the encoder owns and refreshes through `refold`: the
            # folded tree of a ResNet on one device (a ViT serves the caller's own module)
            if n == 1 and graphs.engages(replicate, self.device, obs.shape[0]):
                out = self._replay(obs, fast)
                if out is not None:
                    return out
            outs = []
            for i in range(n):  # every part is queued before any result is read
                device = self.device if i == 0 else self.devices[i]
                with span(ENCODER_H2D):
                    part = obs[i * per:(i + 1) * per].to(device)
                weights = self._replicas[i] if replicate else self.convnet
                with span(ENCODER_EMBED):
                    outs.append(self._embed(weights, part.permute(0, 2, 3, 1), fast))  # NHWC
            return outs[0] if n == 1 else torch.cat([o.to(outs[0].device) for o in outs])

    def _replay(self, obs: torch.Tensor, fast: bool) -> Optional[torch.Tensor]:
        """The forward of `obs` by its key's CUDA graph, or None where this call runs
        eagerly: the key's first call, and every call of a key whose capture raised."""
        key = (tuple(obs.shape), obs.dtype, self.precision)
        cache = self._graphs
        with cache.lock:
            if key in cache.failed or not cache.seen(key):
                return None
            entry = cache.entries[key]
            if entry is None:
                try:
                    entry = self._capture(obs, fast)
                except RuntimeError as e:
                    cache.failed.add(key)
                    del cache.entries[key]
                    self.graph_fallbacks += 1
                    if self.graph_fallbacks == 1:
                        warnings.warn(f"R3MEncoder: capturing the forward of {key} as a "
                                      f"CUDA graph raised ({e}); that input runs eagerly")
                    return None
                cache.entries[key] = entry
                self.graph_captures += 1
            with span(ENCODER_H2D):
                entry.static_in.copy_(obs)
            with span(ENCODER_REPLAY):
                entry.replay()
            maxpool_3x3s2_fwd.launches += entry.k1_launches
            self.graph_replays += 1
            return entry.static_out.clone()

    def _capture(self, obs: torch.Tensor, fast: bool) -> graphs.Graphed:
        weights = self._replicas[0]
        static_in = torch.empty(obs.shape, dtype=obs.dtype, device=self.device)
        static_in.copy_(obs)
        k1 = 0  # K1's launches in the last call of `forward`, the captured one

        def forward(x):
            nonlocal k1
            before = maxpool_3x3s2_fwd.launches
            out = self._embed(weights, x.permute(0, 2, 3, 1), fast)  # NHWC
            k1 = maxpool_3x3s2_fwd.launches - before
            return out

        replay, static_out = graphs.capture(forward, static_in)
        maxpool_3x3s2_fwd.launches -= k1  # the captured launches were recorded, not run
        return graphs.Graphed(replay, static_in, static_out, weights, k1)

    def _embed(self, weights, obs: torch.Tensor, fast: bool) -> torch.Tensor:
        if self.cfg.backbone != "resnet":
            cfg = self.cfg
            if fast:
                cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
            return r3m_embed(cfg, weights, obs)
        x = _preprocess(self.cfg, obs)
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return resnet_apply_folded(weights, x, size=self.cfg.size,
                                   compute_dtype=torch.bfloat16 if fast else None)
