"""Executable PyTorch reference models (the parity oracle); the port's own copy of
``r3m_tpu/torch_oracle.py``.

The standard ResNet architectures written directly in torch with torchvision's state-dict
names (conv1, bn1, layer{1..4}.{i}.conv{j}, downsample.{0,1}, fc), which the reference's
pretrained snapshots use (its __init__.py:73 loads torchvision-backed state dicts,
models_r3m.py:44-52). Where torchvision is installed, `torch_resnet` returns the real
torchvision module instead, so parity runs against the genuine article.
`TorchLanguageReward` mirrors the reference's reward MLP.

It is independent of the port's own models on purpose: ``python -m
r3m_tpu_torch.verify_parity`` holds the port's loaders and encoder against it.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def conv3x3(cin, cout, stride=1):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


def conv1x1(cin, cout, stride=1):
    return nn.Conv2d(cin, cout, 1, stride=stride, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = conv3x3(cin, planes, stride)
        self.bn1 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        idt = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            idt = self.downsample(x)
        return self.relu(out + idt)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = conv1x1(cin, planes)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = conv3x3(planes, planes, stride)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = conv1x1(planes, planes * 4)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        idt = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            idt = self.downsample(x)
        return self.relu(out + idt)


class TorchResNet(nn.Module):
    def __init__(self, block, layers, num_classes=1000):
        super().__init__()
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Identity()  # matches R3M's fc replacement

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                conv1x1(self.inplanes, planes * block.expansion, stride),
                nn.BatchNorm2d(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes * block.expansion
        layers += [block(self.inplanes, planes) for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.avgpool(x).flatten(1)
        return self.fc(x)


def torch_resnet(size: int, prefer_torchvision: bool = True) -> nn.Module:
    """ResNet with torchvision state_dict naming; real torchvision if present.

    The torchvision module (when installed) gets its `fc` replaced by
    Identity, exactly as the reference does (models_r3m.py:62).
    """
    if prefer_torchvision:
        try:
            from torchvision import models as tvm

            builder = {18: tvm.resnet18, 34: tvm.resnet34, 50: tvm.resnet50}.get(size)
            if builder is None:
                raise ValueError(size)
            m = builder()
            m.fc = nn.Identity()
            return m
        except ImportError:
            pass
    if size == 18:
        return TorchResNet(BasicBlock, [2, 2, 2, 2])
    if size == 34:
        return TorchResNet(BasicBlock, [3, 4, 6, 3])
    if size == 50:
        return TorchResNet(Bottleneck, [3, 4, 6, 3])
    raise ValueError(size)


class TorchLanguageReward(nn.Module):
    """Mirror of reference models_language.py:37-55 (5-layer ReLU MLP)."""

    def __init__(self, im_dim, hidden_dim, lang_dim):
        super().__init__()
        self.pred = nn.Sequential(
            nn.Linear(im_dim * 2 + lang_dim, hidden_dim),
            nn.ReLU(),
            nn.Linear(hidden_dim, hidden_dim),
            nn.ReLU(),
            nn.Linear(hidden_dim, hidden_dim),
            nn.ReLU(),
            nn.Linear(hidden_dim, hidden_dim),
            nn.ReLU(),
            nn.Linear(hidden_dim, 1),
        )

    def forward(self, e0, eg, le):
        return self.pred(torch.cat([e0, eg, le], -1)).squeeze()
