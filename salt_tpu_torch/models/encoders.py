"""Encoder families: ResNet 18/34/50/101/152, SE-ResNet, SE-ResNeXt and
DenseNet 121/161/169/201 feature extractors (counterpart of
``salt_tpu/models/encoders.py``: ``encoder_channels`` :42-56,
``SEModule`` :68-81, ``BasicBlock`` :84-114, ``Bottleneck`` :117-161,
``ResNetEncoder`` :164-207, ``DenseLayer`` / ``DenseNetEncoder``
:210-266, ``make_encoder`` :269-288).

Each returns the four stage outputs (encoder2..encoder5). With
``pool0=False`` (the production setting) the stem is a stride-2 7x7 conv
and the max pool is skipped, so a 128x128 input gives maps of 64, 32, 16
and 8. Padding is explicit as in the JAX package: (3, 3) on the stem,
(1, 1) on every 3x3 conv, none on the 1x1 convs.

- ResNet-18/34 stack ``BasicBlock``s (widths 64..512), 50/101/152
  ``Bottleneck``s (256..2048).
- SE variants gate every residual block with :class:`SEModule` before
  the residual add. SE-ResNet strides ``conv1`` (Caffe style,
  ``stride_conv1``); SE-ResNeXt and torchvision ResNet stride ``conv2``,
  SE-ResNeXt with 32 groups of width 4.
- DenseNet layers are BN-ReLU-1x1-BN-ReLU-3x3 and concatenate their
  growth onto their input; the features are taken before each
  transition (BN, ReLU, a 1x1 conv to half the channels, 2x2 average
  pool).

Names copy the flax scopes; ``bn*`` / ``norm*`` / ``downsample_bn`` are
the JAX package's ``_BN`` wrappers, each holding one ``BatchNorm_0``.
Every conv goes through the ``conv`` callable the trunk passes down (the
JAX package's ``conv_fn``), except the SE gates' and the transitions',
which the JAX package builds without it.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from salt_tpu_torch.models.blocks import Conv, apply_conv, batch_norm

RESNET_LAYERS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
RESNET_BOTTLENECK = {18: False, 34: False, 50: True, 101: True, 152: True}
DENSENET_LAYERS = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24),
                   169: (6, 12, 32, 32), 201: (6, 12, 48, 32)}
DENSENET_GROWTH = {121: 32, 161: 48, 169: 32, 201: 32}
DENSENET_INIT = {121: 64, 161: 96, 169: 64, 201: 64}


def encoder_channels(kind: str, depth: int) -> Tuple[int, int, int, int]:
    """Channel counts of (encoder2..encoder5)."""
    if kind == "resnet" and not RESNET_BOTTLENECK[depth]:
        return (64, 128, 256, 512)
    if kind in ("resnet", "se_resnet", "se_resnext"):
        return (256, 512, 1024, 2048)
    if kind == "densenet":
        g, init = DENSENET_GROWTH[depth], DENSENET_INIT[depth]
        n = DENSENET_LAYERS[depth]
        c2 = init + n[0] * g
        c3 = c2 // 2 + n[1] * g
        c4 = c3 // 2 + n[2] * g
        c5 = c4 // 2 + n[3] * g
        return (c2, c3, c4, c5)
    raise ValueError(kind)


class _BN(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.BatchNorm_0 = batch_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(x)


class SEModule(nn.Module):
    """Squeeze-excitation as in pretrainedmodels' senet: the mean over H
    and W, then 1x1 convs ``fc1`` (C // 16) and ``fc2`` (C) with bias,
    ReLU between, sigmoid after."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc1 = nn.Conv2d(channels, hidden, 1)
        self.fc2 = nn.Conv2d(hidden, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(y))))


class _Residual(nn.Module):
    """The tail every residual block shares: the optional SE gate, the
    projection when the shapes differ, the add and the ReLU."""

    def _init_tail(self, in_channels: int, features: int, stride: int,
                   use_se: bool) -> None:
        self.se = SEModule(features) if use_se else None
        # the JAX blocks add the projection when the shapes differ
        self.has_downsample = stride != 1 or in_channels != features
        if self.has_downsample:
            self.downsample_conv = nn.Conv2d(in_channels, features, 1,
                                             stride=stride, bias=False)
            self.downsample_bn = _BN(features)

    def _tail(self, x: torch.Tensor, y: torch.Tensor,
              conv: Conv) -> torch.Tensor:
        if self.se is not None:
            y = self.se(y)
        residual = (self.downsample_bn(apply_conv(conv, self.downsample_conv,
                                                  x))
                    if self.has_downsample else x)
        return F.relu(y + residual)


class BasicBlock(_Residual):
    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 use_se: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 3, stride=stride,
                               padding=1, bias=False)
        self.bn1 = _BN(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = _BN(features)
        self._init_tail(in_channels, features, stride, use_se)

    def forward(self, x: torch.Tensor, conv: Conv = F.conv2d) -> torch.Tensor:
        y = F.relu(self.bn1(apply_conv(conv, self.conv1, x)))
        y = self.bn2(apply_conv(conv, self.conv2, y))
        return self._tail(x, y, conv)


class Bottleneck(_Residual):
    """1x1 -> 3x3 (``groups``) -> 1x1 to ``features`` = 4x the inner
    width; ``stride_conv1`` puts the stride on the 1x1 (pretrainedmodels'
    SEResNetBottleneck), else on the 3x3 (torchvision, SE-ResNeXt)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 groups: int = 1, base_width: int = 64, use_se: bool = False,
                 stride_conv1: bool = False):
        super().__init__()
        width = int(features // 4 * (base_width / 64.0)) * groups
        s1, s2 = (stride, 1) if stride_conv1 else (1, stride)
        self.conv1 = nn.Conv2d(in_channels, width, 1, stride=s1, bias=False)
        self.bn1 = _BN(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=s2, padding=1,
                               groups=groups, bias=False)
        self.bn2 = _BN(width)
        self.conv3 = nn.Conv2d(width, features, 1, bias=False)
        self.bn3 = _BN(features)
        self._init_tail(in_channels, features, stride, use_se)

    def forward(self, x: torch.Tensor, conv: Conv = F.conv2d) -> torch.Tensor:
        y = F.relu(self.bn1(apply_conv(conv, self.conv1, x)))
        y = F.relu(self.bn2(apply_conv(conv, self.conv2, y)))
        y = self.bn3(apply_conv(conv, self.conv3, y))
        return self._tail(x, y, conv)


class _Stem(nn.Module):
    """A stride-2 7x7 conv, BN and ReLU, then the optional max pool."""

    def _stem(self, x: torch.Tensor, conv_m: nn.Conv2d, bn: nn.Module,
              conv: Conv) -> torch.Tensor:
        x = F.relu(bn(apply_conv(conv, conv_m, x)))
        if self.pool0:
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        return x


class ResNetEncoder(_Stem):
    def __init__(self, depth: int = 34, pool0: bool = False,
                 use_se: bool = False, groups: int = 1, base_width: int = 64,
                 stride_conv1: bool = False):
        super().__init__()
        if depth not in RESNET_LAYERS:
            raise KeyError(f"ResNet depth {depth}: expected one of "
                           f"{sorted(RESNET_LAYERS)}")
        bottleneck = RESNET_BOTTLENECK[depth]
        self.pool0 = pool0
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _BN(64)
        cin = 64
        self.stage_names: List[List[str]] = []
        widths = encoder_channels("resnet", depth)
        for stage, (w, n) in enumerate(zip(widths, RESNET_LAYERS[depth])):
            names = []
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f"layer{stage + 1}_{i}"
                block = (Bottleneck(cin, w, stride, groups, base_width,
                                    use_se, stride_conv1) if bottleneck
                         else BasicBlock(cin, w, stride, use_se))
                self.add_module(name, block)
                names.append(name)
                cin = w
            self.stage_names.append(names)

    def forward(self, x: torch.Tensor,
                conv: Conv = F.conv2d) -> Tuple[torch.Tensor, ...]:
        x = self._stem(x, self.conv1, self.bn1, conv)
        feats = []
        for names in self.stage_names:
            for name in names:
                x = getattr(self, name)(x, conv)
            feats.append(x)
        return tuple(feats)


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth: int):
        super().__init__()
        self.norm1 = _BN(in_channels)
        self.conv1 = nn.Conv2d(in_channels, 4 * growth, 1, bias=False)
        self.norm2 = _BN(4 * growth)
        self.conv2 = nn.Conv2d(4 * growth, growth, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor, conv: Conv = F.conv2d) -> torch.Tensor:
        y = apply_conv(conv, self.conv1, F.relu(self.norm1(x)))
        y = apply_conv(conv, self.conv2, F.relu(self.norm2(y)))
        return torch.cat([x, y.to(x.dtype)], dim=1)


class DenseNetEncoder(_Stem):
    def __init__(self, depth: int = 121, pool0: bool = False):
        super().__init__()
        if depth not in DENSENET_LAYERS:
            raise KeyError(f"DenseNet depth {depth}: expected one of "
                           f"{sorted(DENSENET_LAYERS)}")
        growth = DENSENET_GROWTH[depth]
        c = DENSENET_INIT[depth]
        self.pool0 = pool0
        self.conv0 = nn.Conv2d(3, c, 7, stride=2, padding=3, bias=False)
        self.norm0 = _BN(c)
        self.block_names: List[List[str]] = []
        layers = DENSENET_LAYERS[depth]
        for b, n in enumerate(layers, start=1):
            names = []
            for i in range(n):
                name = f"denseblock{b}_{i}"
                self.add_module(name, DenseLayer(c, growth))
                names.append(name)
                c += growth
            self.block_names.append(names)
            if b < len(layers):
                self.add_module(f"transition{b}_norm", _BN(c))
                self.add_module(f"transition{b}_conv",
                                nn.Conv2d(c, c // 2, 1, bias=False))
                c //= 2

    def forward(self, x: torch.Tensor,
                conv: Conv = F.conv2d) -> Tuple[torch.Tensor, ...]:
        x = self._stem(x, self.conv0, self.norm0, conv)
        feats = []
        for b, names in enumerate(self.block_names, start=1):
            for name in names:
                x = getattr(self, name)(x, conv)
            feats.append(x)
            if b < len(self.block_names):
                x = F.relu(getattr(self, f"transition{b}_norm")(x))
                x = getattr(self, f"transition{b}_conv")(x)
                x = F.avg_pool2d(x, 2, stride=2)
        return tuple(feats)


def make_encoder(kind: str, depth: int, pool0: bool = False) -> nn.Module:
    """The trunk's ``encoder`` for ``kind`` ("resnet", "se_resnet",
    "se_resnext", "densenet") at ``depth``."""
    if kind == "resnet":
        return ResNetEncoder(depth, pool0)
    if kind == "se_resnet":
        return ResNetEncoder(depth, pool0, use_se=True, stride_conv1=True)
    if kind == "se_resnext":
        return ResNetEncoder(depth, pool0, use_se=True, groups=32,
                             base_width=4)
    if kind == "densenet":
        return DenseNetEncoder(depth, pool0)
    raise ValueError(f"unknown encoder kind {kind!r}")
