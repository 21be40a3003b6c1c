"""LargeKernelMatters: a ResNet encoder, a global convolutional network
(GCN) and a boundary refinement (BR) at each of its four stages, then a
ladder of stride-2 transposed convs with additive skips (counterpart of
``salt_tpu/models/large_kernel_matters.py``, built as the JAX registry's
``_lkm`` builds it, ``salt_tpu/models/registry.py:118-125``).

At a 128x128 input the stages are at 64, 32, 16 and 8; each GCN (k x 1
then 1 x k, plus 1 x k then k x 1, k = ``kernel_size``) and BR maps its
stage to ``internal_channels`` (21); ``deconv5`` .. ``deconv2`` double
the resolution from 8 to 128, each sum with the next stage refined by a
BR, and ``dec_br1`` refines the last. ``final`` is an fp32 1x1 conv with
bias.

The JAX registry's build function hands this net no dropout and no
conv callable, so ``model.pallas_conv`` and ``model.quant_bits`` do not
reach it, and its infer form is its train form.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from salt_tpu_torch.models.blocks import (BoundaryRefinement,
                                          DeconvConvBnRelu, Fp32HeadNet,
                                          GlobalConvolutionalNetwork)
from salt_tpu_torch.models.encoders import encoder_channels, make_encoder


class LargeKernelMatters(Fp32HeadNet):
    head_name = "final"

    def __init__(self, num_classes: int = 2, encoder_depth: int = 34,
                 kernel_size: int = 9, internal_channels: int = 21,
                 use_relu: bool = True, dropout_2d: float = 0.0,
                 pool0: bool = False, pad_mode: str = "same"):
        super().__init__(dropout_2d)
        c = internal_channels
        self.encoder = make_encoder("resnet", encoder_depth, pool0)
        for stage, c_in in zip("2345", encoder_channels("resnet",
                                                        encoder_depth)):
            self.add_module(f"gcn_{stage}", GlobalConvolutionalNetwork(
                c_in, c, kernel_size, use_relu, pad_mode))
            self.add_module(f"enc_br_{stage}",
                            BoundaryRefinement(c, 3, pad_mode))
        for stage in "5432":
            self.add_module(f"deconv{stage}",
                            DeconvConvBnRelu(c, c, pad_mode))
        for stage in "4321":
            self.add_module(f"dec_br{stage}",
                            BoundaryRefinement(c, 3, pad_mode))
        self.final = nn.Conv2d(c, num_classes, 1)

    def _trunk(self, x: torch.Tensor, generator: Optional[torch.Generator],
               infer: bool) -> torch.Tensor:
        enc2, enc3, enc4, enc5 = self.encoder(x)
        enc5 = self._channel_dropout(enc5, generator)
        g2, g3, g4, g5 = (
            getattr(self, f"enc_br_{s}")(getattr(self, f"gcn_{s}")(feat))
            for s, feat in zip("2345", (enc2, enc3, enc4, enc5)))
        d = self.deconv5(g5)
        for stage, skip in zip("432", (g4, g3, g2)):
            d = getattr(self, f"dec_br{stage}")(d + skip)
            d = getattr(self, f"deconv{stage}")(d)
        return self.dec_br1(d)
