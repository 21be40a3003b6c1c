"""Augmentation-policy preview, the ``augment-preview`` command
(counterpart of ``salt_tpu/pipeline/preview.py``; reference:
notebooks/augmentations.ipynb, policies at
common_blocks/augmentation.py:34-64).

A PNG grid: one row per source image, the original followed by
``n_samples`` independent draws of the full training policy
(``ops/augment.py::apply_augment``, the train step's own, geometry
shared by image and mask). Each cell stacks the image over its mask.
Column ``s``'s policy is drawn from a ``torch.Generator`` on ``device``
seeded ``seed * 1_000_003 + s``: deterministic for a seed, but not the
JAX package's draws (the ``draw`` argument takes any other source).
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Union

import numpy as np
import torch

from salt_tpu_torch.core.device import resolve_device
from salt_tpu_torch.ops.augment import (AugmentParams, apply_augment,
                                        draw_augment_params)

_SEP = 3  # pixel gutter between grid cells


def render_preview_grid(images_u8: np.ndarray, masks_u8: np.ndarray,
                        n_samples: int = 6, seed: int = 0,
                        device: Union[str, torch.device] = "cuda",
                        draw: Optional[Callable[[int], AugmentParams]] = None
                        ) -> np.ndarray:
    """[N, H, W] uint8 images and masks -> the uint8 grid. Column 0 is
    the input; column s + 1 applies ``draw(s)`` (by default the
    generator draw above)."""
    images = np.asarray(images_u8)
    masks = np.asarray(masks_u8)
    if images.ndim != 3 or images.shape != masks.shape:
        raise ValueError(f"expected matching [N,H,W] images/masks, got "
                         f"{images.shape} vs {masks.shape}")
    dev = resolve_device(device)
    n, h, w = images.shape
    x = torch.from_numpy(images).to(dev, torch.float32) / 255.0
    m = (torch.from_numpy(masks).to(dev) > 0).to(torch.float32)
    if draw is None:
        generator = torch.Generator(device=dev)

        def draw(s):
            generator.manual_seed(seed * 1_000_003 + s)
            return draw_augment_params(generator, n, h, w)

    columns = [(images.astype(np.float32) / 255.0,
                (masks > 0).astype(np.float32))]
    for s in range(n_samples):
        ai, am = apply_augment(draw(s).to(dev), x, m)
        columns.append((ai.cpu().numpy(), am.cpu().numpy()))

    rows = []
    for i in range(n):
        cells = []
        for ci, mi in columns:
            img = (np.clip(ci[i], 0.0, 1.0) * 255).astype(np.uint8)
            msk = ((mi[i] > 0.5) * 255).astype(np.uint8)
            cells.append(np.concatenate([img, msk], axis=0))  # [2H, W]
        gut = np.full((2 * h, _SEP), 128, np.uint8)
        row = cells[0]
        for cell in cells[1:]:
            row = np.concatenate([row, gut, cell], axis=1)
        rows.append(row)
    gut = np.full((_SEP, rows[0].shape[1]), 128, np.uint8)
    grid = rows[0]
    for row in rows[1:]:
        grid = np.concatenate([grid, gut, row], axis=0)
    return grid


def augment_preview(bundle, out_path: str, n_images: int = 6,
                    n_samples: int = 6, seed: int = 0,
                    device: Union[str, torch.device] = "cuda",
                    draw: Optional[Callable[[int], AugmentParams]] = None
                    ) -> str:
    """Save the preview grid of the first ``n_images`` of a DataBundle;
    returns the path."""
    from PIL import Image
    n = min(n_images, len(bundle.images))
    if n == 0:
        raise ValueError("bundle has no images to preview")
    if bundle.masks is None:
        masks = np.zeros_like(np.asarray(bundle.images[:n]))
    else:
        masks = np.asarray(bundle.masks[:n])
    grid = render_preview_grid(np.asarray(bundle.images[:n]), masks,
                               n_samples=n_samples, seed=seed, device=device,
                               draw=draw)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    Image.fromarray(grid).save(out_path)
    return out_path
