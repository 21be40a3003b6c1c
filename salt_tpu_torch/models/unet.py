"""The flagship U-Net: ResNet encoder -> center -> five scSE decoder
blocks -> hypercolumn head (counterpart of ``salt_tpu/models/unet.py``,
``UNetTrunk`` :25-154 for the resnet kind and ``UNetResNet`` :157-170).

Shapes at a 128x128 input: enc2..enc5 at 64, 32, 16, 8; the center
(2x ConvBnRelu, then 2x2 average pool) at 4; dec5..dec1 at 8..128 (dec1
takes no skip); the hypercolumn concatenates dec1 with dec2..dec5
upsampled x2, x4, x8, x16 into ``final_conv``, then a 1x1 ``head`` with
bias.

Precision, two modes; the head runs in fp32 on an fp32 copy of its
input and the logits come out fp32 in both, as in the JAX package:
- serving (:meth:`UNetTrunk.set_compute_dtype`): the trunk's weights are
  cast to the config's ``training.dtype`` and it computes in it;
- training (:meth:`UNetTrunk.set_training_precision`): every parameter
  stays fp32, as flax keeps them (no module sets ``param_dtype``), and
  the trunk computes in ``training.dtype`` under ``torch.autocast``, so
  the optimizer never updates a bf16 copy.

Two forms of one module, as the JAX runner builds two models over one
parameter tree (``salt_tpu/train/steps.py:62-67``): ``forward(x)`` is the
train form (literal concats, plain convs: training and the validation
loss); ``forward(x, infer=True)`` the infer form (the predict steps):
the config's ``decoder_impl`` / ``hypercolumn_impl`` ("sum": the sliced
concat of ``blocks.sliced_concat_conv``, the default) and its conv
callable (``model.pallas_conv``). Both read the same parameter tensors.

``dropout_2d`` is channel dropout on enc5 in train mode (flax
``nn.Dropout(broadcast_dims=(1, 2))``), its mask drawn from the
generator passed to ``forward``.
"""
from __future__ import annotations

from typing import List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from salt_tpu_torch.models.blocks import (Conv, ConvBnRelu, DecoderBlock,
                                          Fp32HeadNet, upsample2x)
from salt_tpu_torch.models.encoders import RESNET_WIDTHS, ResNetEncoder


class UNetTrunk(Fp32HeadNet):
    def __init__(self, encoder_depth: int = 34, num_classes: int = 2,
                 use_hypercolumn: bool = True, pool0: bool = False,
                 bottom_channels: int = 512, pad_mode: str = "same",
                 upsample_mode: str = "half_pixel", dropout_2d: float = 0.0,
                 hypercolumn_impl: str = "sum", decoder_impl: str = "sum",
                 infer_conv: Conv = F.conv2d):
        super().__init__(dropout_2d)
        b = bottom_channels
        self.hypercolumn_impl = hypercolumn_impl
        self.decoder_impl = decoder_impl
        self.infer_conv = infer_conv
        c2, c3, c4, c5 = RESNET_WIDTHS
        center = b // 2
        self.use_hypercolumn = use_hypercolumn
        self.upsample_mode = upsample_mode
        kw = dict(pad_mode=pad_mode)
        self.encoder = ResNetEncoder(encoder_depth, pool0)
        self.center_conv1 = ConvBnRelu(c5, b, **kw)
        self.center_conv2 = ConvBnRelu(b, center, **kw)
        dkw = dict(pad_mode=pad_mode, upsample_mode=upsample_mode)
        self.dec5 = DecoderBlock(center, c5, b, b // 8, **dkw)
        self.dec4 = DecoderBlock(b // 8, c4, b // 2, b // 8, **dkw)
        self.dec3 = DecoderBlock(b // 8, c3, b // 4, b // 8, **dkw)
        self.dec2 = DecoderBlock(b // 8, c2, b // 8, b // 8, **dkw)
        self.dec1 = DecoderBlock(b // 8, 0, b // 16, b // 8, **dkw)
        head_in = 5 * (b // 8) if use_hypercolumn else b // 8
        self.final_conv = ConvBnRelu(head_in, b // 8, **kw)
        self.head = nn.Conv2d(b // 8, num_classes, 1)

    def _trunk(self, x: torch.Tensor, generator: Optional[torch.Generator],
               infer: bool) -> torch.Tensor:
        conv = self.infer_conv if infer else F.conv2d
        sliced = infer and self.decoder_impl == "sum"
        enc2, enc3, enc4, enc5 = self.encoder(x, conv)
        enc5 = self._channel_dropout(enc5, generator)
        center = self.center_conv2(self.center_conv1(enc5, conv), conv)
        center = F.avg_pool2d(center, 2, stride=2)
        dec5 = self.dec5(center, enc5, conv, sliced)
        dec4 = self.dec4(dec5, enc4, conv, sliced)
        dec3 = self.dec3(dec4, enc3, conv, sliced)
        dec2 = self.dec2(dec3, enc2, conv, sliced)
        head: Union[torch.Tensor, List[torch.Tensor]] = self.dec1(
            dec2, None, conv)
        if self.use_hypercolumn:
            um = self.upsample_mode
            head = [head,
                    upsample2x(dec2, 2, um),
                    upsample2x(dec3, 4, um),
                    upsample2x(dec4, 8, um),
                    upsample2x(dec5, 16, um)]
            if not (infer and self.hypercolumn_impl == "sum"):
                head = torch.cat(head, dim=1)
        return self.final_conv(head, conv)


def UNetResNet(encoder_depth: int = 34, num_classes: int = 2,
               use_hypercolumn: bool = True, pool0: bool = False,
               pad_mode: str = "same", upsample_mode: str = "half_pixel",
               dropout_2d: float = 0.0, hypercolumn_impl: str = "sum",
               decoder_impl: str = "sum",
               infer_conv: Conv = F.conv2d) -> UNetTrunk:
    return UNetTrunk(encoder_depth=encoder_depth, num_classes=num_classes,
                     use_hypercolumn=use_hypercolumn, pool0=pool0,
                     bottom_channels=512, pad_mode=pad_mode,
                     upsample_mode=upsample_mode, dropout_2d=dropout_2d,
                     hypercolumn_impl=hypercolumn_impl,
                     decoder_impl=decoder_impl, infer_conv=infer_conv)
