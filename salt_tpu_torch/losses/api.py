"""Loss selection (counterpart of ``salt_tpu/losses/api.py`` :19-40).

Every loss takes (logits [B, H, W, C], one-hot target [B, H, W, C]),
NHWC as in the JAX package: the Lovász hinge (the production loss) and
its size-weighted variant, the stable BCE, dice and the mixed dice
losses (``losses/dice.py``), and the focal loss, plain and with the size
and border weights (``losses/focal.py``).
"""
from __future__ import annotations

from typing import Callable

import torch

from salt_tpu_torch.losses.dice import (mixed_dice_bce_loss,
                                        mixed_dice_cross_entropy_loss,
                                        multiclass_dice_loss)
from salt_tpu_torch.losses.focal import weighted_focal_loss
from salt_tpu_torch.losses.lovasz import lovasz_hinge, stable_bce_with_logits

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def get_loss_fn(name: str) -> LossFn:
    losses = {
        "lovasz": lambda out, tgt: lovasz_hinge(out, tgt, per_image=True),
        "lovasz_size_weighted": lambda out, tgt: lovasz_hinge(
            out, tgt, per_image=True, size_weighted=True),
        "bce": stable_bce_with_logits,
        "dice": lambda out, tgt: multiclass_dice_loss(out, tgt,
                                                      activation="sigmoid"),
        "mixed_dice_bce": mixed_dice_bce_loss,
        "mixed_dice_ce": mixed_dice_cross_entropy_loss,
        "focal": weighted_focal_loss,
        "focal_weighted": lambda out, tgt: weighted_focal_loss(
            out, tgt, use_size_weight=True, use_border_weight=True),
    }
    if name not in losses:
        raise KeyError(f"unknown loss {name!r}; choose from {sorted(losses)}")
    return losses[name]
