"""The reference of one served submission, in plain float32: what the
fold ensemble's probabilities are for raw uint8 101x101 images.

- Preprocess: x / 255, edge-pad 101 -> 128 (13 rows on top, 14 below,
  14 columns left, 13 right), ``(x - 0.485) / 0.229``, then three
  channels: the gray, a row ramp ``linspace(0, 1, 128)`` and their
  product.
- hflip TTA: the raw image and its left-right flip, each padded and run
  through the network; the sigmoid of each logit plane, the flipped one
  flipped back at 128x128, their mean; the crop back to 101x101.
- The fold mean: the salt channel's probabilities summed over the folds
  in float32 and divided by their number.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

MEAN, STD = 0.485, 0.229
TOP, BOTTOM, LEFT, RIGHT = 13, 14, 14, 13


def preprocess(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, 101, 101] -> fp32 [B, 3, 128, 128]."""
    x = images_u8.float()[:, None] / 255.0
    x = F.pad(x, (LEFT, RIGHT, TOP, BOTTOM), mode="replicate")
    g = (x - MEAN) / STD
    ramp = torch.linspace(0.0, 1.0, g.shape[-2], device=g.device)[:, None]
    ramp = ramp.expand_as(g[:, 0])[:, None]
    return torch.cat([g, ramp, g * ramp], dim=1)


def tta_probs(model: torch.nn.Module, images_u8: torch.Tensor,
              conv: Optional[Callable] = None) -> torch.Tensor:
    """The salt probabilities [B, 101, 101] of one model with hflip TTA."""
    p = torch.sigmoid(model(preprocess(images_u8), conv))
    q = torch.sigmoid(model(preprocess(images_u8.flip(-1)), conv)).flip(-1)
    mean = (p + q) / 2
    return mean[:, 1, TOP:128 - BOTTOM, LEFT:128 - RIGHT]


@torch.no_grad()
def fold_mean(models: Sequence[torch.nn.Module], images_u8: torch.Tensor,
              conv: Optional[Callable] = None, block: int = 16) -> torch.Tensor:
    """The ensemble's fp32 probabilities [B, 101, 101], ``block`` images
    at a time."""
    out = []
    for lo in range(0, images_u8.shape[0], block):
        imgs = images_u8[lo:lo + block]
        acc = None
        for m in models:
            p = tta_probs(m, imgs, conv)
            acc = p if acc is None else acc + p
        out.append(acc / len(models))
    return torch.cat(out)
