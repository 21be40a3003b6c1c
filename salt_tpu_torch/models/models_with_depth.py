"""The depth-gated U-Net (counterpart of
``salt_tpu/models/models_with_depth.py`` ``UNetResNetWithDepth`` :26-57).

A ResNet U-Net trunk under the scope ``trunk`` stops before its
``final_conv`` (``UNetTrunk.head_input``, the JAX trunk's
``return_head_input``); ``depth_gate`` (``blocks.DepthChannelExcitation``)
gates those features with the per-image depth (z / 1000), then the
model's own ``final_conv`` and an fp32 1x1 ``head``. Under the
hypercolumn the gate and ``final_conv`` see 5 x bottom // 8 channels.

As in the JAX package the trunk is built with its default decoder, the
sliced-concat "sum" form, in both of the model's forms, and with no
``pool0``: ``model.pool0``, ``decoder_impl`` and ``hypercolumn_impl``
have no effect on it. The infer form differs from the train form by the
conv callable alone.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from salt_tpu_torch.models.blocks import (Conv, ConvBnRelu,
                                          DepthChannelExcitation,
                                          Fp32HeadNet)
from salt_tpu_torch.models.unet import UNetTrunk


class UNetResNetWithDepth(Fp32HeadNet):
    takes_depth = True

    def __init__(self, num_classes: int = 2, encoder_depth: int = 34,
                 dropout_2d: float = 0.0, use_hypercolumn: bool = True,
                 pad_mode: str = "same", upsample_mode: str = "half_pixel",
                 infer_conv: Conv = F.conv2d):
        super().__init__()
        bottom = 512 if encoder_depth in (18, 34) else 2048
        self.infer_conv = infer_conv
        self.trunk = UNetTrunk(encoder_kind="resnet",
                               encoder_depth=encoder_depth,
                               use_hypercolumn=use_hypercolumn,
                               bottom_channels=bottom, pad_mode=pad_mode,
                               upsample_mode=upsample_mode,
                               dropout_2d=dropout_2d, with_head=False)
        c = self.trunk.head_channels
        self.depth_gate = DepthChannelExcitation(c)
        self.final_conv = ConvBnRelu(c, bottom // 8, pad_mode=pad_mode)
        self.head = nn.Conv2d(bottom // 8, num_classes, 1)

    def _trunk(self, x: torch.Tensor, generator: Optional[torch.Generator],
               infer: bool, depth: torch.Tensor) -> torch.Tensor:
        conv = self.infer_conv if infer else F.conv2d
        feats = self.trunk.head_input(x, generator, conv, sliced=True,
                                      as_list=False)
        return self.final_conv(self.depth_gate(feats, depth), conv)
