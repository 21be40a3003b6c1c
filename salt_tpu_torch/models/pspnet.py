"""PSPNet: pyramid pooling over a ResNet encoder, a PReLU upsample ladder
and a hypercolumn head (counterpart of ``salt_tpu/models/pspnet.py``,
built as the JAX registry's ``_pspnet`` builds it,
``salt_tpu/models/registry.py:128-134``).

- :func:`adaptive_avg_pool` is ``F.adaptive_avg_pool2d``: its bins are
  the JAX package's (``_adaptive_avg_matrix``: bin i spans
  [floor(i n / s), ceil((i + 1) n / s)) ).
- :class:`PSPModule` pools enc5 to 1, 2, 3 and 6, maps each by a 1x1
  conv without bias (``stage_<s>``), resizes it back bilinearly
  (``blocks.resize_bilinear``), concatenates the four priors with enc5
  and applies the 1x1 ``bottleneck`` (with bias) and a ReLU.
- :class:`PSPUpsample` upsamples x2, then ``Conv_0`` (3x3 SAME, bias),
  ``BatchNorm_0`` and a PReLU with one scalar ``prelu_alpha`` (flax
  param of shape (), initialised to 0.25).
- :class:`PSPNet`: ``up4`` .. ``up1`` halve ``deep_features_size``
  (1024) four times; with ``use_hypercolumn`` the head input is up1 and
  up2, up3, up4 upsampled to its size (960 channels at 128x128), else
  up4 alone; then ``final_conv`` (ConvBnRelu to bottom // 8) and the fp32
  1x1 ``head``.

The JAX registry's build function hands this net no dropout and no
conv callable, so ``model.pallas_conv`` and ``model.quant_bits`` do not
reach it, and its infer form is its train form.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from salt_tpu_torch.models.blocks import (ConvBnRelu, Fp32HeadNet,
                                          batch_norm, resize_bilinear,
                                          upsample2x)
from salt_tpu_torch.models.encoders import encoder_channels, make_encoder


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """NCHW average pool to (``out_size``, ``out_size``) with
    ``AdaptiveAvgPool2d``'s bins."""
    return F.adaptive_avg_pool2d(x, out_size)


class PSPModule(nn.Module):
    def __init__(self, in_channels: int, out_features: int = 1024,
                 sizes: Sequence[int] = (1, 2, 3, 6),
                 upsample_mode: str = "half_pixel"):
        super().__init__()
        self.sizes = tuple(sizes)
        self.upsample_mode = upsample_mode
        for size in self.sizes:
            self.add_module(f"stage_{size}", nn.Conv2d(
                in_channels, in_channels, 1, bias=False))
        self.bottleneck = nn.Conv2d(in_channels * (len(self.sizes) + 1),
                                    out_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        priors = [resize_bilinear(getattr(self, f"stage_{s}")(
            adaptive_avg_pool(x, s)), h, w, self.upsample_mode)
            for s in self.sizes]
        return F.relu(self.bottleneck(torch.cat(priors + [x], dim=1)))


class PSPUpsample(nn.Module):
    def __init__(self, in_channels: int, features: int,
                 upsample_mode: str = "half_pixel"):
        super().__init__()
        self.upsample_mode = upsample_mode
        self.Conv_0 = nn.Conv2d(in_channels, features, 3, padding=1)
        self.BatchNorm_0 = batch_norm(features)
        self.prelu_alpha = nn.Parameter(torch.tensor(0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(upsample2x(x,
                                                    mode=self.upsample_mode)))
        return torch.where(x >= 0, x, self.prelu_alpha.to(x.dtype) * x)


class PSPNet(Fp32HeadNet):
    def __init__(self, num_classes: int = 2, encoder_depth: int = 34,
                 sizes: Sequence[int] = (1, 2, 3, 6),
                 deep_features_size: int = 1024, dropout_2d: float = 0.0,
                 use_hypercolumn: bool = True, pool0: bool = False,
                 pad_mode: str = "same", upsample_mode: str = "half_pixel"):
        super().__init__(dropout_2d)
        bottom = 512 if encoder_depth in (18, 34) else 2048
        f = deep_features_size
        self.use_hypercolumn = use_hypercolumn
        self.upsample_mode = upsample_mode
        c5 = encoder_channels("resnet", encoder_depth)[-1]
        self.encoder = make_encoder("resnet", encoder_depth, pool0)
        self.psp = PSPModule(c5, f, sizes, upsample_mode)
        self.up4 = PSPUpsample(f, f // 2, upsample_mode)
        self.up3 = PSPUpsample(f // 2, f // 4, upsample_mode)
        self.up2 = PSPUpsample(f // 4, f // 8, upsample_mode)
        self.up1 = PSPUpsample(f // 8, f // 16, upsample_mode)
        head_in = (f // 2 + f // 4 + f // 8 + f // 16 if use_hypercolumn
                   else f // 2)
        self.final_conv = ConvBnRelu(head_in, bottom // 8, pad_mode)
        self.head = nn.Conv2d(bottom // 8, num_classes, 1)

    def _trunk(self, x: torch.Tensor, generator: Optional[torch.Generator],
               infer: bool) -> torch.Tensor:
        enc5 = self._channel_dropout(self.encoder(x)[-1], generator)
        up4 = self.up4(self.psp(enc5))
        up3 = self.up3(up4)
        up2 = self.up2(up3)
        up1 = self.up1(up2)
        if self.use_hypercolumn:
            um = self.upsample_mode
            head_in = torch.cat([up1, upsample2x(up2, 2, um),
                                 upsample2x(up3, 4, um),
                                 upsample2x(up4, 8, um)], dim=1)
        else:
            head_in = up4
        return self.final_conv(self._channel_dropout(head_in, generator))
