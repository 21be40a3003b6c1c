"""Dice and the mixed segmentation losses (counterpart of
``salt_tpu/losses/dice.py`` :11-68; reference:
common_blocks/models.py:315-388).

Logits and one-hot targets are NHWC [B, H, W, C], as every loss of the
port takes them (``losses/api.py``); the sums are fp32.
"""
from __future__ import annotations

import torch

from salt_tpu_torch.losses.lovasz import stable_bce_with_logits


def dice_loss(output: torch.Tensor, target: torch.Tensor,
              smooth: float = 0.0, eps: float = 1e-7) -> torch.Tensor:
    """1 - Dice over already-activated outputs (reference:
    models.py:315-323)."""
    output = output.to(torch.float32)
    target = target.to(torch.float32)
    num = 2.0 * torch.sum(output * target) + smooth
    den = torch.sum(output) + torch.sum(target) + smooth + eps
    return 1.0 - num / den


def multiclass_dice_loss(output: torch.Tensor, target: torch.Tensor,
                         smooth: float = 0.0,
                         activation: str = "softmax") -> torch.Tensor:
    """The mean over classes of the dice loss of each class plane:
    ``output`` logits, ``target`` one-hot (reference: models.py:361-388)."""
    if activation == "softmax":
        probs = torch.softmax(output, dim=-1)
    elif activation == "sigmoid":
        probs = torch.sigmoid(output)
    else:
        raise NotImplementedError("only sigmoid and softmax are implemented")
    return torch.stack([dice_loss(probs[..., i], target[..., i], smooth)
                        for i in range(probs.shape[-1])]).mean()


def mixed_dice_bce_loss(output: torch.Tensor, target: torch.Tensor,
                        dice_weight: float = 0.2, bce_weight: float = 0.9,
                        smooth: float = 0.0,
                        dice_activation: str = "sigmoid") -> torch.Tensor:
    """(reference: models.py:331-340)."""
    return (dice_weight * multiclass_dice_loss(output, target, smooth,
                                               dice_activation)
            + bce_weight * stable_bce_with_logits(output, target))


def mixed_dice_cross_entropy_loss(output: torch.Tensor,
                                  target: torch.Tensor,
                                  dice_weight: float = 0.5,
                                  cross_entropy_weight: float = 0.5,
                                  smooth: float = 0.0,
                                  dice_activation: str = "softmax"
                                  ) -> torch.Tensor:
    """Dice over the logits' classes 1.. against the target's leading C-1
    planes, plus cross entropy against labels rebuilt from those planes
    (plane i set -> class i + 1, the last set plane winning; reference:
    models.py:343-358)."""
    c = output.shape[-1]
    labels = torch.zeros(target.shape[:-1], dtype=torch.int64,
                         device=target.device)
    for class_nr in range(c - 1):
        labels = torch.where(target[..., class_nr] > 0, class_nr + 1, labels)
    log_probs = torch.log_softmax(output.to(torch.float32), dim=-1)
    ce = -log_probs.gather(-1, labels[..., None]).mean()
    return (dice_weight * multiclass_dice_loss(output[..., 1:],
                                               target[..., :c - 1], smooth,
                                               dice_activation)
            + cross_entropy_weight * ce)
