"""Weighted focal loss (counterpart of ``salt_tpu/losses/focal.py``
:34-82, the knobs of the reference's weighted_focal_loss notebook):

- ``alpha`` / ``gamma``: ``alpha * (1 - p_t)^gamma * BCE`` per pixel;
- ``focus_threshold``: pixels with ``p_t >= 1 - focus_threshold`` add
  nothing;
- ``use_size_weight`` / ``max_weight``: foreground pixels of an image
  weighted by its inverse foreground fraction, clipped to
  [1, max_weight];
- ``use_border_weight`` / ``border_size`` / ``border_weight``: pixels
  within ``border_size`` of the mask's boundary weighted
  ``1 + border_weight``.

The weighted mean over every pixel and channel. Logits and one-hot
targets are NHWC [B, H, W, C]; the weight maps come from the target's
last (foreground) plane.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def boundary_band(fg: torch.Tensor, border_size: int) -> torch.Tensor:
    """1.0 within ``border_size`` of the fg / bg boundary of ``fg``
    [B, H, W] in {0, 1}: dilation minus erosion over a
    (2 border_size + 1)^2 window. The JAX package's ``reduce_window``
    with SAME padding pads an odd window by border_size on each side with
    the reduction's identity, which is ``max_pool2d``'s padding (it never
    takes a padded value) on ``fg`` for the dilation and on ``-fg`` for
    the erosion."""
    k = 2 * border_size + 1
    x = fg[:, None]
    dilated = F.max_pool2d(x, k, stride=1, padding=border_size)
    eroded = -F.max_pool2d(-x, k, stride=1, padding=border_size)
    return (dilated - eroded)[:, 0]


def weighted_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                        alpha: float = 1.0, gamma: float = 2.0,
                        focus_threshold: float = 0.0,
                        use_size_weight: bool = False,
                        max_weight: float = 100.0,
                        use_border_weight: bool = False,
                        border_size: int = 10,
                        border_weight: float = 10.0) -> torch.Tensor:
    logits = logits.to(torch.float32)
    targets = targets.to(torch.float32)
    # the stable BCE per pixel, as in stable_bce_with_logits
    bce = (torch.clamp(logits, min=0) - logits * targets
           + torch.log1p(torch.exp(-torch.abs(logits))))
    p = torch.sigmoid(logits)
    p_t = targets * p + (1.0 - targets) * (1.0 - p)
    loss = alpha * (1.0 - p_t) ** gamma * bce
    if focus_threshold > 0.0:
        loss = torch.where(p_t >= 1.0 - focus_threshold, 0.0, loss)

    weight = torch.ones_like(loss)
    fg = targets[..., -1]                                   # [B, H, W]
    if use_size_weight:
        n_px = fg.shape[-1] * fg.shape[-2]
        frac = fg.sum(dim=(-1, -2), keepdim=True) / n_px
        size_w = torch.clamp(1.0 / torch.clamp(frac, min=1.0 / max_weight),
                             1.0, max_weight)               # [B, 1, 1]
        weight = weight * torch.where(fg > 0, size_w, 1.0)[..., None]
    if use_border_weight and border_size > 0:
        band = boundary_band(fg, border_size)
        weight = weight * (1.0 + border_weight * band)[..., None]
    return torch.sum(loss * weight) / torch.clamp(weight.sum(), min=1.0)
