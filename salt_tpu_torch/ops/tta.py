"""Test-time augmentation: specs, forward/inverse transforms, aggregation.

Counterpart of ``salt_tpu/ops/tta.py`` (:33-94), same semantics:
- the identity spec comes first, then the cartesian product of the
  enabled options minus the identity (hflip alone: identity, lr-flip);
- rotation is in degrees, multiples of 90, counter-clockwise as
  ``numpy.rot90``;
- forward order: ud flip -> lr flip -> (color shift: identity) ->
  rotate; inverse order: un-rotate -> un-lr -> un-ud.
"""
from __future__ import annotations

from itertools import product
from typing import Dict, List

import torch


def build_tta_specs(flip_ud: bool = False, flip_lr: bool = True,
                    rotation: bool = False, color_shift_runs: int = 0
                    ) -> List[Dict]:
    specs = [{"ud_flip": False, "lr_flip": False, "rotation": 0,
              "color_shift": False}]
    ud_options = [True, False] if flip_ud else [False]
    lr_options = [True, False] if flip_lr else [False]
    rot_options = [0, 90, 180, 270] if rotation else [0]
    color_options = (list(range(1, color_shift_runs + 1))
                     if color_shift_runs else [False])
    for ud, lr, rot, color in product(ud_options, lr_options, rot_options,
                                      color_options):
        if ud is False and lr is False and rot == 0 and color is False:
            continue
        specs.append({"ud_flip": ud, "lr_flip": lr, "rotation": rot,
                      "color_shift": color})
    return specs


def tta_transform(images: torch.Tensor, spec: Dict) -> torch.Tensor:
    """Forward TTA on [..., H, W] batches."""
    x = images
    if spec["ud_flip"]:
        x = torch.flip(x, dims=(-2,))
    if spec["lr_flip"]:
        x = torch.flip(x, dims=(-1,))
    k = (spec["rotation"] // 90) % 4
    if k:
        x = torch.rot90(x, k, dims=(-2, -1))
    return x


def tta_inverse_transform(probs: torch.Tensor, spec: Dict) -> torch.Tensor:
    """Inverse TTA on [..., H, W] prediction maps (channels lead)."""
    x = probs
    k = (-(spec["rotation"] // 90)) % 4
    if k:
        x = torch.rot90(x, k, dims=(-2, -1))
    if spec["lr_flip"]:
        x = torch.flip(x, dims=(-1,))
    if spec["ud_flip"]:
        x = torch.flip(x, dims=(-2,))
    return x


def aggregate(stack: torch.Tensor, method: str = "mean") -> torch.Tensor:
    """Reduce a [T, ...] stack of per-spec predictions."""
    if method == "mean":
        return stack.mean(dim=0)
    if method == "max":
        return stack.amax(dim=0)
    if method == "min":
        return stack.amin(dim=0)
    if method == "gmean":
        return torch.exp(torch.log(stack.clamp_min(1e-12)).mean(dim=0))
    raise KeyError(f"unknown aggregation {method!r}")
