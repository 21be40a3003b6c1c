"""The scratch U-Nets, with no pretrained encoder: ``SaltUNet`` and
``SaltLinkNet`` (counterpart of ``salt_tpu/models/salt_unet.py``).

``repeat_blocks`` levels, each two k x k ConvBnRelu (SaltLinkNet: one
3x3) and a 2x2 max pool of stride 2 (VALID: an odd side loses its last
row or column); widths ``min(n_filters * 2^i, 8 * n_filters)``. SaltUNet
decodes each level with the flagship's scSE ``DecoderBlock`` (middle 2w,
out w) over the concat of the upsampled features and the skip;
SaltLinkNet upsamples, applies one ConvBnRelu and adds the skip. The 1x1
head (``Conv_0``) and the logits are fp32.

Submodule names are the flax auto-names (``ConvBnRelu_0``, ...,
``DecoderBlock_0``, ..., ``Conv_0``), so ``models.convert`` maps a
checkpoint of either package. They have no sliced-concat sum forms, and
``model.pallas_conv`` does not reach them, as in the JAX package. Their
infer form is their train form but for ``infer_conv``, the conv of every
ConvBnRelu with ``model.quant_bits=8`` (the int8 convs; the SE gates and
the fp32 head stay in full precision). Here the port parts from the JAX
package, whose registry hands these nets no conv callable, so that its
``quant_bits=8`` leaves them in full precision: the distillation curve's
``saltunet32_int8`` student (``tools/distill_curve.py``) is served int8
as that tool means it to be.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from salt_tpu_torch.models.blocks import (Conv, ConvBnRelu, DecoderBlock,
                                          Fp32HeadNet, upsample2x)


def level_widths(n_filters: int, repeat_blocks: int) -> List[int]:
    """Features at each of the ``repeat_blocks`` levels and the bottom."""
    return [min(n_filters * 2 ** i, n_filters * 8)
            for i in range(repeat_blocks + 1)]


class _ScratchNet(Fp32HeadNet):
    head_name = "Conv_0"

    def __init__(self, dropout_2d: float = 0.0,
                 infer_conv: Conv = F.conv2d):
        super().__init__(dropout_2d)
        self.infer_conv = infer_conv

    def _add_convs(self, start: int, widths_in_out, kernel_size: int,
                   use_batch_norm: bool) -> None:
        """ConvBnRelu_<start>, ... for each (in, out)."""
        for i, (c_in, c_out) in enumerate(widths_in_out, start):
            self.add_module(f"ConvBnRelu_{i}", ConvBnRelu(
                c_in, c_out, kernel_size=kernel_size,
                use_batch_norm=use_batch_norm))

    def _conv(self, i: int) -> ConvBnRelu:
        return getattr(self, f"ConvBnRelu_{i}")


class SaltUNet(_ScratchNet):
    def __init__(self, num_classes: int = 2, n_filters: int = 16,
                 conv_kernel: int = 3, repeat_blocks: int = 4,
                 use_batch_norm: bool = True, dropout_2d: float = 0.0,
                 infer_conv: Conv = F.conv2d):
        super().__init__(dropout_2d, infer_conv)
        widths = level_widths(n_filters, repeat_blocks)
        pairs, c = [], 3
        for w in widths:
            pairs += [(c, w), (w, w)]
            c = w
        self.n_levels = repeat_blocks
        self._add_convs(0, pairs, conv_kernel, use_batch_norm)
        for j, w in enumerate(reversed(widths[:-1])):
            # the skip of a level has the level's width
            self.add_module(f"DecoderBlock_{j}", DecoderBlock(c, w, 2 * w, w))
            c = w
        self.Conv_0 = nn.Conv2d(c, num_classes, 1)

    def _trunk(self, x: torch.Tensor, generator: Optional[torch.Generator],
               infer: bool) -> torch.Tensor:
        conv = self.infer_conv if infer else F.conv2d
        skips = []
        for level in range(self.n_levels + 1):
            x = self._conv(2 * level + 1)(self._conv(2 * level)(x, conv),
                                          conv)
            if level < self.n_levels:
                skips.append(x)
                x = F.max_pool2d(x, 2, stride=2)
        x = self._channel_dropout(x, generator)
        for j, skip in enumerate(reversed(skips)):
            x = getattr(self, f"DecoderBlock_{j}")(x, skip, conv)
        return x


class SaltLinkNet(_ScratchNet):
    def __init__(self, num_classes: int = 2, n_filters: int = 16,
                 repeat_blocks: int = 4, use_batch_norm: bool = True,
                 infer_conv: Conv = F.conv2d):
        super().__init__(infer_conv=infer_conv)
        widths = level_widths(n_filters, repeat_blocks)
        ins = [3] + widths[:-1]
        down = list(zip(ins, widths))
        up = list(zip(widths[:0:-1], widths[-2::-1]))
        self.n_levels = repeat_blocks
        self._add_convs(0, down + up, 3, use_batch_norm)
        self.Conv_0 = nn.Conv2d(widths[0], num_classes, 1)

    def _trunk(self, x: torch.Tensor, generator: Optional[torch.Generator],
               infer: bool) -> torch.Tensor:
        conv = self.infer_conv if infer else F.conv2d
        skips = []
        for level in range(self.n_levels):
            x = self._conv(level)(x, conv)
            skips.append(x)
            x = F.max_pool2d(x, 2, stride=2)
        x = self._conv(self.n_levels)(x, conv)
        for j, skip in enumerate(reversed(skips)):
            x = self._conv(self.n_levels + 1 + j)(upsample2x(x), conv)
            x = x + skip.to(x.dtype)
        return x
