"""ResNet-18/34/50 visual encoders, the port of ``r3m_tpu/models/resnet.py``.

`ResNet` is an ``nn.Module`` whose state-dict keys are torchvision's (``conv1``, ``bn1``,
``layer{1..4}.{i}.conv{j}`` / ``bn{j}``, ``downsample.0`` / ``.1``; ``fc`` is the
reference's Identity and holds nothing), so a reference ``model.pt`` loads as it is. Its
forward is the encoder in eval mode (``train=False``: BatchNorm reads the running
statistics) or in train mode (``train=True``: batch statistics, running statistics
updated in place; with ``remat="conv_saved"`` the BatchNorm normalise and ReLUs are
recomputed in the backward instead of kept). Serving folds BatchNorm into the
convolutions once (`fold_batchnorm`) and runs `resnet_apply_folded`. Both run NCHW
tensors in channels_last memory, so the stem pool (kernels K1 and K2,
`r3m_tpu_torch.ops.pool`) reads physical NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from r3m_tpu_torch.ops.pool import maxpool_3x3s2


@dataclasses.dataclass(frozen=True)
class ResNetSpec:
    name: str
    block: str  # "basic" | "bottleneck"
    stage_sizes: Tuple[int, int, int, int]
    width: int = 64
    expansion: int = 1

    @property
    def out_dim(self) -> int:
        return self.width * 8 * self.expansion


RESNET_SPECS: Dict[int, ResNetSpec] = {
    18: ResNetSpec("resnet18", "basic", (2, 2, 2, 2), expansion=1),
    34: ResNetSpec("resnet34", "basic", (3, 4, 6, 3), expansion=1),
    50: ResNetSpec("resnet50", "bottleneck", (3, 4, 6, 3), expansion=4),
}

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
REMAT_MODES = ("none", "conv_saved")


def resnet_out_dim(size: int) -> int:
    return RESNET_SPECS[size].out_dim


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class _Block(nn.Module):
    """A basic (two 3x3) or bottleneck (1x1, 3x3, 1x1) residual block, torchvision names."""

    def __init__(self, cin: int, planes: int, stride: int, expansion: int, basic: bool):
        super().__init__()
        cout = planes * expansion
        if basic:
            self.conv1 = _conv(cin, planes, 3, stride)
            self.bn1 = nn.BatchNorm2d(planes)
            self.conv2 = _conv(planes, planes, 3)
            self.bn2 = nn.BatchNorm2d(planes)
        else:  # torchvision v1.5: the stride sits on the 3x3
            self.conv1 = _conv(cin, planes, 1)
            self.bn1 = nn.BatchNorm2d(planes)
            self.conv2 = _conv(planes, planes, 3, stride)
            self.bn2 = nn.BatchNorm2d(planes)
            self.conv3 = _conv(planes, cout, 1)
            self.bn3 = nn.BatchNorm2d(cout)
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride), nn.BatchNorm2d(cout))
        else:
            self.downsample = None

    def pairs(self) -> List[Tuple[str, nn.Conv2d, nn.BatchNorm2d]]:
        """(name, conv, bn) for every convolution of the block, in forward order."""
        out = [("conv1", self.conv1, self.bn1), ("conv2", self.conv2, self.bn2)]
        if hasattr(self, "conv3"):
            out.append(("conv3", self.conv3, self.bn3))
        if self.downsample is not None:
            out.append(("downsample", self.downsample[0], self.downsample[1]))
        return out


class ResNet(nn.Module):
    """torchvision-layout ResNet-18/34/50 without its ``fc`` head.

    Built with torchvision's initialisation (Kaiming-normal fan-out convolutions, unit
    BatchNorm), drawn from torch's global generator.
    """

    def __init__(self, size: int):
        super().__init__()
        if size not in RESNET_SPECS:
            raise ValueError(f"ResNet size must be one of {sorted(RESNET_SPECS)}, got {size}")
        spec = RESNET_SPECS[size]
        self.size = size
        self.conv1 = nn.Conv2d(3, spec.width, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(spec.width)
        cin = spec.width
        for stage, num_blocks in enumerate(spec.stage_sizes):
            planes = spec.width * 2**stage
            blocks = []
            for b in range(num_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(
                    _Block(cin, planes, stride, spec.expansion, spec.block == "basic")
                )
                cin = planes * spec.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")

    def blocks(self):
        for stage in range(4):
            yield from getattr(self, f"layer{stage + 1}")

    def forward(self, x: torch.Tensor, train: bool = False, bn_group=None,
                remat: str = "none") -> torch.Tensor:
        """NCHW normalized images -> ``[B, out_dim]`` f32 features; convolutions run in
        x.dtype (weights cast to it, as ``resnet.py:92`` does).

        ``train=False`` is the port of ``resnet_apply(train=False)``: BatchNorm reads its
        running statistics whatever the module's mode. ``train=True`` is the port of
        ``resnet_apply(train=True)``: BatchNorm normalises with the batch statistics and
        updates the running statistics in place (`_bn_train`); with `bn_group` (a process
        group, the data-parallel step's) the statistics are those of every rank's rows
        together (`_bn_train_synced`). ``remat="conv_saved"`` trains through
        `_forward_conv_saved`, which keeps fewer activations for the backward; an unknown
        mode raises ValueError.
        """
        if remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {remat!r}; expected one of {REMAT_MODES}")
        if train and remat == "conv_saved":
            return self._forward_conv_saved(x, bn_group)
        if not train:
            bn_fn = _bn_eval
        elif bn_group is None:
            bn_fn = _bn_train
        else:
            def bn_fn(y, bn):
                return _bn_train_synced(y, bn, bn_group)

        def conv_bn(y, conv, bn, stride, padding):
            y = F.conv2d(y, conv.weight.to(y.dtype), None, stride, padding)
            return bn_fn(y, bn)

        y = F.relu(conv_bn(x, self.conv1, self.bn1, 2, 3))
        y = _pool(y)
        for blk in self.blocks():
            stride = blk.conv2.stride[0] if hasattr(blk, "conv3") else blk.conv1.stride[0]
            sc = y
            if blk.downsample is not None:
                sc = conv_bn(y, blk.downsample[0], blk.downsample[1], stride, 0)
            if hasattr(blk, "conv3"):
                h = F.relu(conv_bn(y, blk.conv1, blk.bn1, 1, 0))
                h = F.relu(conv_bn(h, blk.conv2, blk.bn2, stride, 1))
                h = conv_bn(h, blk.conv3, blk.bn3, 1, 0)
            else:
                h = F.relu(conv_bn(y, blk.conv1, blk.bn1, stride, 1))
                h = conv_bn(h, blk.conv2, blk.bn2, 1, 1)
            y = F.relu(h + sc)
        return y.to(torch.float32).mean(dim=(2, 3))

    def _forward_conv_saved(self, x: torch.Tensor, bn_group=None) -> torch.Tensor:
        """The train forward with ``remat="conv_saved"``, the port of ``resnet_apply``'s
        (``resnet.py:338-391``): the same function as ``remat="none"``, with fewer
        activations kept for the backward.

        What the backward keeps: each block's input, every convolution's output and each
        BatchNorm's ``[C]`` batch moments. What it recomputes: every BatchNorm normalise,
        ReLU and residual add inside a block, from those (the JAX policy's
        ``save_only_these_names("conv_out", "bn_stat")``). The stem (conv1, bn1, ReLU and
        the pool through kernels K1/K2) runs as in ``remat="none"``, outside any
        checkpoint.

        Each BatchNorm's moments (`_batch_moments`: per-channel sums of y and y² in f32,
        all-reduced over `bn_group` where one is given) are taken outside any checkpoint,
        and the running statistics are updated there, once. Between two convolutions of a
        block, normalise + ReLU + the next convolution run under
        `torch.utils.checkpoint.checkpoint` with a selective policy that saves the
        convolution's output (`_remat`): the backward re-runs the normalise and the ReLU
        (elementwise) to rebuild the convolution's input, and no reduction and no
        collective. The normalise is the JAX form, ``y * inv + (bias - mean * inv)`` in
        f32 with ``var = E[y²] - E[y]²``, so the loss and gradients agree with
        ``remat="none"`` (torch's fused BatchNorm) to rounding, not bit for bit.
        """
        def bn_stem(y, bn):
            if bn_group is None:
                return _bn_train(y, bn)
            return _bn_train_synced(y, bn, bn_group)

        y = F.relu(bn_stem(_conv_in(x, self.conv1, 2, 3), self.bn1))
        y = _pool(y)
        for blk in self.blocks():
            y = _block_conv_saved(blk, y, bn_group)
        return y.to(torch.float32).mean(dim=(2, 3))


def _conv_in(y: torch.Tensor, conv: nn.Conv2d, stride: int, padding: int) -> torch.Tensor:
    return F.conv2d(y, conv.weight.to(y.dtype), None, stride, padding)


class _Moments(torch.autograd.Function):
    """Per-channel sums of y and y² over (N, H, W), in f32, as one ``[2C]`` vector. It
    saves y alone (which its caller keeps anyway), where autograd of ``y.float()`` would
    save an f32 copy; its backward is ``g_sum + 2 * g_sumsq * y``."""

    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        yf = y.to(torch.float32)
        return torch.cat([yf.sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3))])

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        c = y.shape[1]
        g_sum, g_sumsq = grad[:c, None, None], grad[c:, None, None]
        return torch.addcmul(g_sum, y.to(torch.float32), g_sumsq, value=2.0).to(y.dtype)


def _batch_moments(y: torch.Tensor, bn: nn.BatchNorm2d, group) -> Tuple[torch.Tensor, ...]:
    """The batch mean and biased variance of `y` over (N, H, W) — and over every rank of
    `group` — as JAX computes them (``E[y²] - E[y]²`` in f32); the running statistics are
    updated with them, once."""
    from r3m_tpu_torch.parallel.collectives import all_reduce_sum

    c = y.shape[1]
    n = y.numel() // c
    sums = _Moments.apply(y)
    if group is not None:
        n *= dist.get_world_size(group)
        sums = all_reduce_sum(sums, group)
    mean = sums[:c] / n
    var = sums[c:] / n - mean * mean
    _update_running_stats(bn, mean, var, n)
    return mean, var


def _normalize(y: torch.Tensor, mean, var, weight, bias) -> torch.Tensor:
    """Train BatchNorm's affine map from given batch moments: f32 math, y.dtype out."""
    inv = torch.rsqrt(var + BN_EPS) * weight.float()
    shift = bias.float() - mean * inv
    return torch.addcmul(shift[:, None, None], y.to(torch.float32),
                         inv[:, None, None]).to(y.dtype)


def _norm_relu_conv(y, mean, var, bn_weight, bn_bias, conv_weight, stride: int,
                    padding: int):
    h = F.relu(_normalize(y, mean, var, bn_weight, bn_bias))
    return F.conv2d(h, conv_weight.to(h.dtype), None, stride, padding)


def _tail(y, mean, var, bn_weight, bn_bias, *shortcut):
    """A block's output, ``relu(bn(y) + shortcut)``: the shortcut is the block input, or
    (with a downsample) its convolution's output, moments and BatchNorm parameters."""
    sc = shortcut[0] if len(shortcut) == 1 else _normalize(*shortcut)
    return F.relu(_normalize(y, mean, var, bn_weight, bn_bias) + sc)


def _save_convolutions(ctx, func, *args, **kwargs):
    if func is torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, *args):
    """`fn(*args)` under a selective checkpoint: convolution outputs are kept, every other
    op of `fn` is recomputed in the backward."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: create_selective_checkpoint_contexts(
                          _save_convolutions))


def _block_conv_saved(blk: _Block, x: torch.Tensor, group) -> torch.Tensor:
    """One residual block under ``remat="conv_saved"`` (`ResNet._forward_conv_saved`)."""
    if hasattr(blk, "conv3"):  # bottleneck: the stride sits on the 3x3
        stride = blk.conv2.stride[0]
        layers = [(blk.conv1, blk.bn1, 1, 0), (blk.conv2, blk.bn2, stride, 1),
                  (blk.conv3, blk.bn3, 1, 0)]
    else:
        stride = blk.conv1.stride[0]
        layers = [(blk.conv1, blk.bn1, stride, 1), (blk.conv2, blk.bn2, 1, 1)]
    conv, bn, s, p = layers[0]
    y = _conv_in(x, conv, s, p)
    for conv, next_bn, s, p in layers[1:]:
        mean, var = _batch_moments(y, bn, group)
        y = _remat(_norm_relu_conv, y, mean, var, bn.weight, bn.bias, conv.weight, s, p)
        bn = next_bn
    mean, var = _batch_moments(y, bn, group)
    if blk.downsample is None:
        shortcut = (x,)
    else:
        ds_conv, ds_bn = blk.downsample
        d = _conv_in(x, ds_conv, stride, 0)
        shortcut = (d, *_batch_moments(d, ds_bn, group), ds_bn.weight, ds_bn.bias)
    return _remat(_tail, y, mean, var, bn.weight, bn.bias, *shortcut)


def _update_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor,
                          n: int) -> None:
    """Momentum 0.1 updates of the running mean and of the running variance, the latter
    with the unbiased estimate over `n` values."""
    with torch.no_grad():
        bn.running_mean.mul_(1 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
        bn.running_var.mul_(1 - BN_MOMENTUM).add_(var * (n / max(n - 1, 1)),
                                                   alpha=BN_MOMENTUM)


def _bn_train(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Train BatchNorm as the JAX ``batch_norm(train=True)``: normalise with the biased
    batch variance, update the running variance with the unbiased one, momentum 0.1,
    eps 1e-5; statistics in f32 and the f32 scale and bias, output in y.dtype.

    This is torch's own BatchNorm in training mode (cuDNN on the card), whose running
    statistics it updates in place. JAX takes the variance as E[x^2] - E[x]^2 in f32;
    torch sums otherwise, which differs only by rounding.
    """
    return F.batch_norm(
        y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
        training=True, momentum=BN_MOMENTUM, eps=BN_EPS,
    )


def _bn_train_synced(y: torch.Tensor, bn: nn.BatchNorm2d, group) -> torch.Tensor:
    """Train BatchNorm over the rows of every rank of `group`, the JAX
    ``batch_norm(train=True)`` of the global batch (``resnet.py:100-130``): each rank sums
    its rows and their squares over (N, H, W) in f32, one all-reduce adds the sums, and
    mean = sum / n, variance = sumsq / n - mean^2, as JAX computes them; normalised with
    the biased variance, the running variance updated with the unbiased one over the
    global count, momentum 0.1, eps 1e-5; output in y.dtype.

    Every rank holds as many rows (the gather of the embeddings needs it too), so the
    global count is the local one times the world size, exact on the host. The gradient
    flows through the autograd all-reduce (`all_reduce_sum`).
    """
    from r3m_tpu_torch.parallel.collectives import all_reduce_sum

    c = y.shape[1]
    n = y.numel() // c * dist.get_world_size(group)
    dims = (0, 2, 3)
    yf = y.to(torch.float32)
    sums = all_reduce_sum(torch.cat([yf.sum(dim=dims), (yf * yf).sum(dim=dims)]), group)
    mean = sums[:c] / n
    var = sums[c:] / n - mean * mean
    _update_running_stats(bn, mean, var, n)
    inv = torch.rsqrt(var + BN_EPS) * bn.weight.float()
    shift = bn.bias.float() - mean * inv
    return torch.addcmul(shift[:, None, None], yf, inv[:, None, None]).to(y.dtype)


def _bn_eval(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval BatchNorm as the JAX ``batch_norm(train=False)``: f32 math, y.dtype out."""
    inv = torch.rsqrt(bn.running_var.float() + BN_EPS) * bn.weight.float()
    shift = bn.bias.float() - bn.running_mean.float() * inv
    out = y.to(torch.float32) * inv[:, None, None] + shift[:, None, None]
    return out.to(y.dtype)


def _pool(y: torch.Tensor) -> torch.Tensor:
    """The stem pool through K1 (and K2 for its gradient). The kernels take NHWC: a
    channels_last NCHW tensor permutes to a contiguous NHWC view at no cost, and the
    result permutes back to a channels_last NCHW tensor."""
    return maxpool_3x3s2(y.permute(0, 2, 3, 1).contiguous()).permute(0, 3, 1, 2)


def fold_batchnorm(net: ResNet, eps: float = BN_EPS) -> Dict[str, Any]:
    """Fold eval-mode BN into the preceding conv: w' = w*inv, b' = bias - mean*inv.

    The same math as conv -> eval BatchNorm, without any normalize pass at inference.
    Returns ``{"conv1": {"w", "b"}, "layer1": [{"conv1": ..., ...}, ...], ...}`` in f32,
    with convolution weights in channels_last memory.
    """

    def fold(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> Dict[str, torch.Tensor]:
        inv = bn.weight.float() * torch.rsqrt(bn.running_var.float() + eps)
        w = conv.weight.float() * inv[:, None, None, None]
        return {
            "w": w.contiguous(memory_format=torch.channels_last),
            "b": bn.bias.float() - bn.running_mean.float() * inv,
        }

    with torch.no_grad():
        folded: Dict[str, Any] = {"conv1": fold(net.conv1, net.bn1)}
        for stage in range(4):
            name = f"layer{stage + 1}"
            folded[name] = [
                {key: fold(conv, bn) for key, conv, bn in blk.pairs()}
                for blk in getattr(net, name)
            ]
    return folded


def cast_folded(folded: Dict[str, Any], dtype: torch.dtype, device=None) -> Dict[str, Any]:
    """The folded tree with every tensor in `dtype` (serving casts once, not per call),
    on `device` if given."""
    if isinstance(folded, dict):
        return {k: cast_folded(v, dtype, device) for k, v in folded.items()}
    if isinstance(folded, list):
        return [cast_folded(v, dtype, device) for v in folded]
    return folded.to(device=device, dtype=dtype)


def _conv_bias(x, p, stride, padding):
    return F.conv2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), stride, padding)


def resnet_apply_folded(
    folded: Dict[str, Any], x: torch.Tensor, *, size: int, compute_dtype=None
) -> torch.Tensor:
    """Inference forward over BN-folded params: NCHW normalized -> ``[B, out_dim]`` f32.

    `compute_dtype` casts the input (and so every convolution) to that dtype; pass x in
    channels_last memory for the stem pool to read it without a copy.
    """
    spec = RESNET_SPECS[size]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    y = F.relu(_conv_bias(x, folded["conv1"], 2, 3))
    y = _pool(y)
    basic = spec.block == "basic"
    for stage, num_blocks in enumerate(spec.stage_sizes):
        for b in range(num_blocks):
            p = folded[f"layer{stage + 1}"][b]
            stride = 2 if (stage > 0 and b == 0) else 1
            sc = _conv_bias(y, p["downsample"], stride, 0) if "downsample" in p else y
            if basic:
                h = F.relu(_conv_bias(y, p["conv1"], stride, 1))
                h = _conv_bias(h, p["conv2"], 1, 1)
            else:
                h = F.relu(_conv_bias(y, p["conv1"], 1, 0))
                h = F.relu(_conv_bias(h, p["conv2"], stride, 1))
                h = _conv_bias(h, p["conv3"], 1, 0)
            y = F.relu(h + sc)
    return y.to(torch.float32).mean(dim=(2, 3))
