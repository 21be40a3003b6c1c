"""The U-Net family: an encoder -> center -> five scSE decoder blocks ->
hypercolumn head (counterpart of ``salt_tpu/models/unet.py``: ``UNetTrunk``
:25-154, the factories ``UNetResNet`` :157-170, ``UNetSeResNet``,
``UNetSeResNetXt`` and ``UNetDenseNet`` :173-222).

Shapes at a 128x128 input: enc2..enc5 at 64, 32, 16, 8, their widths
``encoders.encoder_channels`` of the encoder; the center (2x ConvBnRelu,
the second to ``center_out`` or b // 2 channels, then 2x2 average pool)
at 4; dec5..dec1 at 8..128 (dec1 takes no skip); the hypercolumn
concatenates dec1 with dec2..dec5 upsampled x2, x4, x8, x16 into
``final_conv``, then a 1x1 ``head`` with bias. The bottom width b is 512
for ResNet-18/34, 2048 for the bottleneck encoders and the last dense
block's width for DenseNet, whose center emits enc4's width.

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
:meth:`UNetTrunk.head_input` is the JAX trunk's ``return_head_input``:
the features before ``final_conv``, which a trunk built with
``with_head=False`` (the depth model's) stops at.

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
from salt_tpu_torch.models.encoders import encoder_channels, make_encoder

Branches = Union[torch.Tensor, List[torch.Tensor]]


class UNetTrunk(Fp32HeadNet):
    def __init__(self, *, encoder_kind: str = "resnet",
                 encoder_depth: int = 34, num_classes: int = 2,
                 use_hypercolumn: bool = True, pool0: bool = False,
                 bottom_channels: int = 512, center_out: int = 0,
                 pad_mode: str = "same", upsample_mode: str = "half_pixel",
                 dropout_2d: float = 0.0, hypercolumn_impl: str = "sum",
                 decoder_impl: str = "sum", infer_conv: Conv = F.conv2d,
                 with_head: bool = True):
        super().__init__(dropout_2d)
        b = bottom_channels
        self.hypercolumn_impl = hypercolumn_impl
        self.decoder_impl = decoder_impl
        self.infer_conv = infer_conv
        c2, c3, c4, c5 = encoder_channels(encoder_kind, encoder_depth)
        center = center_out or b // 2
        self.use_hypercolumn = use_hypercolumn
        self.upsample_mode = upsample_mode
        kw = dict(pad_mode=pad_mode)
        self.encoder = make_encoder(encoder_kind, encoder_depth, pool0)
        self.center_conv1 = ConvBnRelu(c5, b, **kw)
        self.center_conv2 = ConvBnRelu(b, center, **kw)
        dkw = dict(pad_mode=pad_mode, upsample_mode=upsample_mode)
        self.dec5 = DecoderBlock(center, c5, b, b // 8, **dkw)
        self.dec4 = DecoderBlock(b // 8, c4, b // 2, b // 8, **dkw)
        self.dec3 = DecoderBlock(b // 8, c3, b // 4, b // 8, **dkw)
        self.dec2 = DecoderBlock(b // 8, c2, b // 8, b // 8, **dkw)
        self.dec1 = DecoderBlock(b // 8, 0, b // 16, b // 8, **dkw)
        #: channels of :meth:`head_input`
        self.head_channels = 5 * (b // 8) if use_hypercolumn else b // 8
        if with_head:
            self.final_conv = ConvBnRelu(self.head_channels, b // 8, **kw)
            self.head = nn.Conv2d(b // 8, num_classes, 1)

    def head_input(self, x: torch.Tensor,
                   generator: Optional[torch.Generator], conv: Conv,
                   sliced: bool, as_list: bool) -> Branches:
        """The features ``final_conv`` takes: the hypercolumn (its five
        branches with ``as_list``, else their concat), or dec1 alone
        without it. ``sliced``: the decoders' sliced-concat form."""
        enc2, enc3, enc4, enc5 = self.encoder(x, conv)
        enc5 = self._channel_dropout(enc5, generator)
        center = self.center_conv2(self.center_conv1(enc5, conv), conv)
        center = F.avg_pool2d(center, 2, stride=2)
        dec5 = self.dec5(center, enc5, conv, sliced)
        dec4 = self.dec4(dec5, enc4, conv, sliced)
        dec3 = self.dec3(dec4, enc3, conv, sliced)
        dec2 = self.dec2(dec3, enc2, conv, sliced)
        dec1 = self.dec1(dec2, None, conv)
        if not self.use_hypercolumn:
            return dec1
        um = self.upsample_mode
        branches = [dec1,
                    upsample2x(dec2, 2, um),
                    upsample2x(dec3, 4, um),
                    upsample2x(dec4, 8, um),
                    upsample2x(dec5, 16, um)]
        return branches if as_list else torch.cat(branches, dim=1)

    def _trunk(self, x: torch.Tensor, generator: Optional[torch.Generator],
               infer: bool) -> torch.Tensor:
        conv = self.infer_conv if infer else F.conv2d
        head = self.head_input(
            x, generator, conv, sliced=infer and self.decoder_impl == "sum",
            as_list=infer and self.hypercolumn_impl == "sum")
        return self.final_conv(head, conv)


def UNetResNet(encoder_depth: int = 34, **kw) -> UNetTrunk:
    """ResNet encoder; bottom 512 at depth 18/34, 2048 at 50/101/152."""
    bottom = 512 if encoder_depth in (18, 34) else 2048
    return UNetTrunk(encoder_kind="resnet", encoder_depth=encoder_depth,
                     bottom_channels=bottom, **kw)


def UNetSeResNet(encoder_depth: int = 50, **kw) -> UNetTrunk:
    return UNetTrunk(encoder_kind="se_resnet", encoder_depth=encoder_depth,
                     bottom_channels=2048, **kw)


def UNetSeResNetXt(encoder_depth: int = 50, **kw) -> UNetTrunk:
    """SE-ResNeXt 32x4d encoder."""
    return UNetTrunk(encoder_kind="se_resnext", encoder_depth=encoder_depth,
                     bottom_channels=2048, **kw)


def UNetDenseNet(encoder_depth: int = 121, **kw) -> UNetTrunk:
    """Bottom = the last dense block's width; the center emits enc4's
    width, not bottom // 2."""
    chans = encoder_channels("densenet", encoder_depth)
    return UNetTrunk(encoder_kind="densenet", encoder_depth=encoder_depth,
                     bottom_channels=chans[-1], center_out=chans[2], **kw)
