"""Loss selection (counterpart of ``salt_tpu/losses/api.py`` :19-40).

Every loss takes (logits [B, H, W, C], one-hot target [B, H, W, C]),
NHWC as in the JAX package. The port has the production Lovász hinge,
its size-weighted variant and the stable BCE; the other names of the
JAX package raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable

import torch

from salt_tpu_torch.losses.lovasz import lovasz_hinge, stable_bce_with_logits

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

#: loss names of the JAX package the port does not have yet
NOT_PORTED = ("dice", "mixed_dice_bce", "mixed_dice_ce", "focal",
              "focal_weighted")


def get_loss_fn(name: str) -> LossFn:
    losses = {
        "lovasz": lambda out, tgt: lovasz_hinge(out, tgt, per_image=True),
        "lovasz_size_weighted": lambda out, tgt: lovasz_hinge(
            out, tgt, per_image=True, size_weighted=True),
        "bce": stable_bce_with_logits,
    }
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"training.loss={name!r} is not ported yet (ROADMAP.md Queue A "
            "item 14, other losses)")
    if name not in losses:
        raise KeyError(f"unknown loss {name!r}; choose from "
                       f"{sorted(losses) + list(NOT_PORTED)}")
    return losses[name]
