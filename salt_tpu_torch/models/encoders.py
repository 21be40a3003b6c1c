"""ResNet-18/34 feature extractor (counterpart of
``salt_tpu/models/encoders.py``: ``BasicBlock`` :84-114,
``ResNetEncoder`` :164-207).

Returns the four stage outputs (encoder2..encoder5). With ``pool0=False``
(the production setting) the stem is a stride-2 7x7 conv and the max pool
is skipped, so a 128x128 input gives maps of 64, 32, 16 and 8. Padding is
explicit as in the JAX package: (3, 3) on the stem, (1, 1) on every 3x3
conv, none on the 1x1 stride-2 downsample.

Names copy the flax scopes; ``bn1``/``bn2``/``downsample_bn`` are the JAX
package's ``_BN`` wrappers, each holding one ``BatchNorm_0``. Every conv,
the stem's included, goes through the ``conv`` callable the trunk passes
down (the JAX package's ``conv_fn``, :89-113, :184-199).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from salt_tpu_torch.models.blocks import Conv, apply_conv, batch_norm

RESNET_LAYERS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}
RESNET_WIDTHS = (64, 128, 256, 512)


class _BN(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.BatchNorm_0 = batch_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(x)


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 3, stride=stride,
                               padding=1, bias=False)
        self.bn1 = _BN(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = _BN(features)
        # the JAX block adds the projection when the shapes differ
        self.has_downsample = stride != 1 or in_channels != features
        if self.has_downsample:
            self.downsample_conv = nn.Conv2d(in_channels, features, 1,
                                             stride=stride, bias=False)
            self.downsample_bn = _BN(features)

    def forward(self, x: torch.Tensor, conv: Conv = F.conv2d) -> torch.Tensor:
        y = F.relu(self.bn1(apply_conv(conv, self.conv1, x)))
        y = self.bn2(apply_conv(conv, self.conv2, y))
        residual = (self.downsample_bn(apply_conv(conv, self.downsample_conv,
                                                  x))
                    if self.has_downsample else x)
        return F.relu(y + residual)


class ResNetEncoder(nn.Module):
    def __init__(self, depth: int = 34, pool0: bool = False):
        super().__init__()
        if depth not in RESNET_LAYERS:
            raise NotImplementedError(
                f"ResNet depth {depth}: the port has the BasicBlock depths "
                f"{sorted(RESNET_LAYERS)} (ROADMAP Queue A, other "
                "architectures)")
        self.pool0 = pool0
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _BN(64)
        cin = 64
        self.stage_names = []
        for stage, (w, n) in enumerate(zip(RESNET_WIDTHS,
                                           RESNET_LAYERS[depth])):
            names = []
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, BasicBlock(cin, w, stride))
                names.append(name)
                cin = w
            self.stage_names.append(names)

    def forward(self, x: torch.Tensor,
                conv: Conv = F.conv2d) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.bn1(apply_conv(conv, self.conv1, x)))
        if self.pool0:
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for names in self.stage_names:
            for name in names:
                x = getattr(self, name)(x, conv)
            feats.append(x)
        return tuple(feats)
