"""The second-level stacking heads over the salt probability maps of N
first-level models (counterpart of ``salt_tpu/models/stacking.py``):
``conv``, a 3x3 ConvBnRelu of the N input channels to ``filter_nr``,
channel dropout in train mode, then the fp32 1x1 ``final`` conv;
``StackingFCNWithDepth`` gates the features with the depth
(``depth_gate``, ``blocks.DepthChannelExcitation``) before ``final``.

Their runner (``stacking-cv``) is ROADMAP Queue A item 16; here they are
modules held against the JAX package's.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from salt_tpu_torch.models.blocks import (ConvBnRelu,
                                          DepthChannelExcitation,
                                          Fp32HeadNet)


class StackingFCN(Fp32HeadNet):
    head_name = "final"

    def __init__(self, input_model_nr: int = 18, num_classes: int = 2,
                 filter_nr: int = 32, dropout_2d: float = 0.0,
                 pad_mode: str = "same"):
        super().__init__(dropout_2d)
        self.conv = ConvBnRelu(input_model_nr, filter_nr, pad_mode)
        self.final = nn.Conv2d(filter_nr, num_classes, 1)

    def _trunk(self, x: torch.Tensor, generator: Optional[torch.Generator],
               infer: bool) -> torch.Tensor:
        return self._channel_dropout(self.conv(x), generator)


class StackingFCNWithDepth(StackingFCN):
    takes_depth = True

    def __init__(self, input_model_nr: int = 18, num_classes: int = 2,
                 filter_nr: int = 32, dropout_2d: float = 0.0,
                 pad_mode: str = "same"):
        super().__init__(input_model_nr, num_classes, filter_nr, dropout_2d,
                         pad_mode)
        self.depth_gate = DepthChannelExcitation(filter_nr)

    def _trunk(self, x: torch.Tensor, generator: Optional[torch.Generator],
               infer: bool, depth: torch.Tensor) -> torch.Tensor:
        return self.depth_gate(super()._trunk(x, generator, infer), depth)
