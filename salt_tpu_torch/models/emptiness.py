"""The empty-vs-salt image classifier (counterpart of
``salt_tpu/models/emptiness.py``): a ResNet trunk without the stem's max
pool, the mean over H and W of its last stage, and an fp32 1x1
``classifier`` conv with bias; logits [B, num_classes].

Its runner is ``train/classifier.py::ClassifierRunner`` (the ``empty-*``
commands, ``full-solution``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from salt_tpu_torch.models.blocks import Fp32HeadNet
from salt_tpu_torch.models.encoders import encoder_channels, make_encoder


class EmptinessClassifier(Fp32HeadNet):
    head_name = "classifier"

    def __init__(self, num_classes: int = 2, encoder_depth: int = 18):
        super().__init__()
        self.encoder = make_encoder("resnet", encoder_depth, pool0=False)
        self.classifier = nn.Conv2d(
            encoder_channels("resnet", encoder_depth)[-1], num_classes, 1)

    def forward(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        """[B, 3, H, W] -> fp32 logits [B, num_classes]."""
        return super().forward(x, *args, **kwargs).flatten(1)

    def _trunk(self, x: torch.Tensor, generator: Optional[torch.Generator],
               infer: bool) -> torch.Tensor:
        return self.encoder(x)[-1].mean(dim=(2, 3), keepdim=True)
