"""The plain float32 reference of the benchmark's U-Nets: UNetResNet-34 and
UNetSeResNeXt-50 (neptune-ai/open-solution-salt-identification,
``common_blocks/architectures/unet.py`` and ``encoders.py``), written
with nothing but ``torch`` and ``torch.nn.functional``.

Shapes at a 128x128 input: a stride-2 7x7 stem (no max pool), the four
residual stages at 64, 32, 16 and 8; a center of two conv-BN-ReLUs and a
2x2 average pool (4); five decoder blocks (upsample x2 half-pixel
bilinear, concat the skip, two conv-BN-ReLUs, ReLU of channel SE plus
spatial SE) back to 128; the hypercolumn (dec1 and dec2..dec5 upsampled
x2..x16) into a 3x3 conv-BN-ReLU and a 1x1 head with bias, two logit
channels. BatchNorm eps 1e-5.

Module names follow the flat checkpoint layout that the served program
restores (``benchmark/weights.py`` writes it from ``state_dict()``).

``forward(x, conv=None)``: ``conv`` replaces the convolution at the
sites the served program hands its conv callable (every encoder conv,
the center, the decoders' and the hypercolumn's conv-BN-ReLUs; not the
SE gates and not the head), with ``F.conv2d``'s signature. A conv over
a concat is the sum of each branch's conv with its slice of the weight,
as the served infer form computes it (and, in exact arithmetic, the conv
of the concat).

Seeding conventions (``seed_conventions``, after the generic draw of
``benchmark/weights.py``): the hypercolumn conv's weight on the three
finest branches (dec1..dec3) is scaled by ``FINE_BRANCH_SCALE``, so the
masks follow the coarse branches and come out in blobs (about 45 runs a
mask) rather than in single pixels; the last BatchNorm of each residual
branch has its scale times ``residual_scale``. ``Encoder`` and ``Block``
(with :func:`scale_residual_branches`) serve any family on these
encoders.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Conv = Callable[..., torch.Tensor]

RESNET_LAYERS = {34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}
#: the 1x1 head's module name
HEAD = "head"
#: leaves with no fan-in: none
FANLESS: dict = {}
#: scale of the hypercolumn conv's weight on the dec1..dec3 branches
FINE_BRANCH_SCALE = 0.1


def bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


def call_conv(conv: Conv, m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x, m.weight, m.bias, m.stride, m.padding, m.dilation,
                m.groups)


class Norm(nn.Module):
    """The checkpoint layout's BatchNorm scope (``<name>/BatchNorm_0``)."""

    def __init__(self, c: int):
        super().__init__()
        self.BatchNorm_0 = bn(c)

    def forward(self, x):
        return self.BatchNorm_0(x)


class SE(nn.Module):
    """Squeeze-excitation of the SE-ResNeXt blocks: mean over H and W,
    1x1 conv to C // 16, ReLU, 1x1 conv to C, sigmoid, times x."""

    def __init__(self, c: int):
        super().__init__()
        self.fc1 = nn.Conv2d(c, c // 16, 1)
        self.fc2 = nn.Conv2d(c // 16, c, 1)

    def forward(self, x):
        y = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(y))))


class Block(nn.Module):
    """A residual block: BasicBlock (two 3x3) or the SE-ResNeXt
    bottleneck (1x1, grouped 3x3 with the stride, 1x1, SE); a 1x1
    projection when the shape changes."""

    def __init__(self, cin: int, cout: int, stride: int, bottleneck: bool,
                 groups: int = 1, base_width: int = 64, use_se: bool = False):
        super().__init__()
        self.bottleneck = bottleneck
        if bottleneck:
            width = int(cout // 4 * (base_width / 64.0)) * groups
            self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
            self.bn1 = Norm(width)
            self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups,
                                   bias=False)
            self.bn2 = Norm(width)
            self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
            self.bn3 = Norm(cout)
        else:
            self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.bn1 = Norm(cout)
            self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.bn2 = Norm(cout)
        self.se = SE(cout) if use_se else None
        self.project = stride != 1 or cin != cout
        if self.project:
            self.downsample_conv = nn.Conv2d(cin, cout, 1, stride, bias=False)
            self.downsample_bn = Norm(cout)

    def forward(self, x, conv: Conv):
        y = F.relu(self.bn1(call_conv(conv, self.conv1, x)))
        y = self.bn2(call_conv(conv, self.conv2, y))
        if self.bottleneck:
            y = self.bn3(call_conv(conv, self.conv3, F.relu(y)))
        if self.se is not None:
            y = self.se(y)
        r = (self.downsample_bn(call_conv(conv, self.downsample_conv, x))
             if self.project else x)
        return F.relu(y + r)


class Encoder(nn.Module):
    def __init__(self, depth: int, bottleneck: bool, widths: Sequence[int],
                 groups: int = 1, base_width: int = 64, use_se: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = Norm(64)
        self.stages: List[List[str]] = []
        cin = 64
        for s, (w, n) in enumerate(zip(widths, RESNET_LAYERS[depth])):
            names = []
            for i in range(n):
                name = f"layer{s + 1}_{i}"
                self.add_module(name, Block(
                    cin, w, 2 if s > 0 and i == 0 else 1, bottleneck,
                    groups, base_width, use_se))
                names.append(name)
                cin = w
            self.stages.append(names)

    def forward(self, x, conv: Conv):
        x = F.relu(self.bn1(call_conv(conv, self.conv1, x)))
        feats = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x, conv)
            feats.append(x)
        return feats


def conv_concat(branches: Sequence[torch.Tensor], m: nn.Conv2d,
                conv: Conv) -> torch.Tensor:
    """``m`` (3x3, padding 1, no bias) over the channel concat of
    ``branches``: the sum of each branch's conv with its slice of the
    weight, in branch order."""
    out, off = None, 0
    for b in branches:
        c = b.shape[1]
        y = conv(b, m.weight[:, off:off + c], None, 1, 1, 1, 1)
        out = y if out is None else out + y
        off += c
    return out


class ConvBnRelu(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, 3, 1, 1, bias=False)
        self.BatchNorm_0 = bn(cout)

    def forward(self, branches, conv: Conv):
        if isinstance(branches, torch.Tensor):
            branches = [branches]
        return F.relu(self.BatchNorm_0(conv_concat(branches, self.Conv_0,
                                                   conv)))


class ChannelSE(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.Dense_0 = nn.Linear(c, c // 16)
        self.Dense_1 = nn.Linear(c // 16, c)

    def forward(self, x):
        y = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(x.mean((2, 3))))))
        return x * y[:, :, None, None]


class SpatialSE(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.Dense_0 = nn.Conv2d(c, 1, 1)

    def forward(self, x):
        return x * torch.sigmoid(self.Dense_0(x))


def up(x: torch.Tensor, factor: int) -> torch.Tensor:
    return F.interpolate(x, scale_factor=factor, mode="bilinear",
                         align_corners=False)


class Decoder(nn.Module):
    def __init__(self, cin: int, cskip: int, cmid: int, cout: int):
        super().__init__()
        self.ConvBnRelu_0 = ConvBnRelu(cin + cskip, cmid)
        self.ConvBnRelu_1 = ConvBnRelu(cmid, cout)
        self.ChannelSELayer_0 = ChannelSE(cout)
        self.SpatialSELayer_0 = SpatialSE(cout)

    def forward(self, x, skip: Optional[torch.Tensor], conv: Conv):
        x = up(x, 2)
        branches = [x] if skip is None else [x, skip]
        x = self.ConvBnRelu_1(self.ConvBnRelu_0(branches, conv), conv)
        return F.relu(self.ChannelSELayer_0(x) + self.SpatialSELayer_0(x))


class UNet(nn.Module):
    def __init__(self, encoder: Encoder, widths: Sequence[int], bottom: int,
                 num_classes: int = 2):
        super().__init__()
        c2, c3, c4, c5 = widths
        b = bottom
        self.encoder = encoder
        self.center_conv1 = ConvBnRelu(c5, b)
        self.center_conv2 = ConvBnRelu(b, b // 2)
        self.dec5 = Decoder(b // 2, c5, b, b // 8)
        self.dec4 = Decoder(b // 8, c4, b // 2, b // 8)
        self.dec3 = Decoder(b // 8, c3, b // 4, b // 8)
        self.dec2 = Decoder(b // 8, c2, b // 8, b // 8)
        self.dec1 = Decoder(b // 8, 0, b // 16, b // 8)
        self.final_conv = ConvBnRelu(5 * (b // 8), b // 8)
        self.head = nn.Conv2d(b // 8, num_classes, 1)

    def forward(self, x: torch.Tensor, conv: Optional[Conv] = None
                ) -> torch.Tensor:
        """[B, 3, 128, 128] -> logits [B, 2, 128, 128]."""
        conv = conv or F.conv2d
        e2, e3, e4, e5 = self.encoder(x, conv)
        c = self.center_conv2(self.center_conv1(e5, conv), conv)
        c = F.avg_pool2d(c, 2, 2)
        d5 = self.dec5(c, e5, conv)
        d4 = self.dec4(d5, e4, conv)
        d3 = self.dec3(d4, e3, conv)
        d2 = self.dec2(d3, e2, conv)
        d1 = self.dec1(d2, None, conv)
        hyper = [d1, up(d2, 2), up(d3, 4), up(d4, 8), up(d5, 16)]
        return self.head(self.final_conv(hyper, conv))


def build(cfg: dict) -> UNet:
    """The configuration file's architecture (``UNetResNet`` or
    ``UNetSeResNetXt``) in fp32, eval mode."""
    arch, depth = cfg["architecture"], cfg["encoder_depth"]
    if arch == "UNetResNet" and depth == 34:
        widths = (64, 128, 256, 512)
        enc = Encoder(depth, False, widths)
    elif arch == "UNetSeResNetXt" and depth == 50:
        widths = (256, 512, 1024, 2048)
        enc = Encoder(depth, True, widths, groups=cfg["groups"],
                      base_width=cfg["base_width"], use_se=True)
    else:
        raise ValueError(f"no reference for {arch}-{depth}")
    if widths[-1] != cfg["encoder_widths"][-1]:
        raise ValueError("encoder widths differ from the configuration's")
    return UNet(enc, widths, cfg["bottom_channels"],
                cfg["num_classes"]).eval()


def build_empty(cfg: dict, device) -> UNet:
    """:func:`build` with uninitialised storage on ``device`` (the
    caller fills every leaf)."""
    with torch.device("meta"):
        model = build(cfg)
    return model.to_empty(device=device)


def scale_residual_branches(model: nn.Module, residual_scale: float) -> None:
    """The last BatchNorm's scale of every residual branch (every
    :class:`Block` in ``model``) times ``residual_scale``."""
    for block in model.modules():
        if isinstance(block, Block):
            last = block.bn3 if block.bottleneck else block.bn2
            last.BatchNorm_0.weight *= residual_scale


@torch.no_grad()
def seed_conventions(model: UNet, residual_scale: float) -> None:
    """The U-Net's scaling of its seeded weights (the module's
    docstring)."""
    w = model.final_conv.Conv_0.weight
    w[:, :3 * w.shape[1] // 5] *= FINE_BRANCH_SCALE
    scale_residual_branches(model, residual_scale)
