"""The distillation train step: soft teacher probabilities and hard
masks (counterpart of ``salt_tpu/train/distill.py``).

The student trains through the standard ``fit`` loop. Its train-side
"mask" array is a uint16 pack ``(hard_mask << 8) | round(teacher_prob *
255)`` (:func:`pack_targets`); the validation side keeps the true uint8
masks, so the IOUT sweep measures the student against the ground truth.
The pack crosses to the device as int16 bits (every device copies
int16; ``torch.uint16`` has few kernels) and is widened to int32 there
before it is unpacked. The loss is ``alpha * BCE(logits, soft) + (1 -
alpha) * training.loss(logits, hard)``, alpha ``training.distill_alpha``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from salt_tpu_torch.core.config import Config
from salt_tpu_torch.ops.augment import (AugmentParams, bilinear_sample,
                                        draw_augment_params, filter_ops,
                                        intensity_ops, make_warp_coords)
from salt_tpu_torch.ops.preprocess import (add_depth_channels, normalize_gray,
                                           one_hot_target, pad_fixed,
                                           resize_hw)
from salt_tpu_torch.train.state import TrainState
from salt_tpu_torch.train.steps import SegmentationRunner


def pack_targets(masks_u8: np.ndarray, teacher_probs: np.ndarray
                 ) -> np.ndarray:
    """(hard mask, teacher salt probability in [0, 1]) -> uint16 pack."""
    hard = (masks_u8 > 0).astype(np.uint16)
    soft = np.clip(np.round(teacher_probs * 255.0), 0, 255).astype(np.uint16)
    return (hard << 8) | soft


def unpack_targets(packed: torch.Tensor):
    """The pack (uint16 values held as int16 or any wider integer) ->
    fp32 (hard {0, 1}, soft in [0, 1])."""
    p = packed.to(torch.int32) & 0xFFFF
    return ((p >> 8) & 0x1).to(torch.float32), (p & 0xFF).to(torch.float32) / 255.0


class DistillRunner(SegmentationRunner):
    """A ``SegmentationRunner`` whose train step takes the packed
    targets; its inference and validation steps are the parent's."""

    def __init__(self, config: Config, device="cuda"):
        self.distill_alpha = float(config.training.distill_alpha)
        super().__init__(config, device)

    def device_batch(self, *arrays: np.ndarray):
        """uint16 arrays cross as their int16 bits."""
        return super().device_batch(*(
            a.view(np.int16) if a.dtype == np.uint16 else a for a in arrays))

    def _distill_inputs(self, images_u8: torch.Tensor, packed: torch.Tensor,
                        params: AugmentParams):
        """One shared warp of the image and both targets (soft targets
        interpolate bilinearly like the image; hard targets re-binarize at
        0.5), then the resize_and_pad (or resize) pipeline. Returns the
        network input [B, 3, H, W] and the soft and hard one-hot targets
        [B, H, W, 2]."""
        x = images_u8.to(torch.float32) / 255.0
        hard, soft = unpack_targets(packed)
        h, w = x.shape[-2:]
        ys, xs = make_warp_coords(params, h, w)
        x = intensity_ops(params, filter_ops(params,
                                             bilinear_sample(x, ys, xs)))
        hard = bilinear_sample(hard, ys, xs)
        soft = bilinear_sample(soft, ys, xs)
        if self._pp["loader_mode"] != "resize":
            size = (self._pp["resize_size"],) * 2
            pad = (self._pp["pad_size"],) * 2
            x, hard, soft = (pad_fixed(resize_hw(t, size), pad,
                                       self._pp["pad_method"])
                             for t in (x, hard, soft))
        else:
            x, hard, soft = (resize_hw(t, self._net_hw)
                             for t in (x, hard, soft))
        y_hard = one_hot_target((hard > 0.5).to(torch.float32))
        y_soft = torch.stack([1.0 - soft, soft], dim=-1)
        x = add_depth_channels(normalize_gray(x)).permute(0, 3, 1, 2)
        return x, y_soft, y_hard

    def train_loss(self, logits: torch.Tensor, y) -> torch.Tensor:
        """``y`` = (soft, hard) targets [B, H, W, 2]."""
        y_soft, y_hard = y
        out = logits.permute(0, 2, 3, 1)
        soft = F.binary_cross_entropy_with_logits(out.float(), y_soft)
        return (self.distill_alpha * soft
                + (1.0 - self.distill_alpha) * self.loss_fn(out, y_hard))

    def train_step(self, state: TrainState, images_u8: torch.Tensor,
                   packed: torch.Tensor, generator: torch.Generator,
                   depths: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w = images_u8.shape
        x, y_soft, y_hard = self._distill_inputs(
            images_u8, packed, draw_augment_params(generator, b, h, w))
        return self.update(state, x, (y_soft, y_hard), generator, depths)
