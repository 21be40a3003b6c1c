"""Image IO and packed-array dataset construction (own copy of
``salt_tpu/data/images.py``).

The reference decodes PNGs per __getitem__ inside DataLoader worker
processes (reference: common_blocks/loaders.py:125-157) — a per-item
Python hot loop. Here PNGs are decoded ONCE into packed uint8 arrays
([N, 101, 101]) that live in host RAM (or a memmap), and every
downstream transform runs on device. Mask binarization keeps the
reference's conventions: >=128 for mask reading (reference:
loaders.py:61, utils.py:82-88) and >0 for load_image(is_mask=True)
(reference: utils.py:506-511).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
from PIL import Image


def load_image(filepath: str, is_mask: bool = False) -> np.ndarray:
    if is_mask:
        return (np.array(Image.open(filepath)) > 0).astype(np.uint8)
    return np.array(Image.open(filepath)).astype(np.uint8)


def save_image(img: np.ndarray, filepath: str) -> None:
    Image.fromarray(img).save(filepath)


def read_masks(masks_filepaths: Sequence[str]) -> List[np.ndarray]:
    """Binarize-at-128 mask reader (reference: utils.py:82-88)."""
    masks = []
    for p in masks_filepaths:
        m = Image.open(p).convert("L")
        masks.append((np.asarray(m) >= 128).astype(np.uint8))
    return masks


def read_images(filepaths: Sequence[str]) -> List[np.ndarray]:
    return [np.array(Image.open(p)) for p in filepaths]


def to_grayscale(img: np.ndarray) -> np.ndarray:
    """Collapse RGB(A) to a single luminance channel; TGS images are
    grayscale stored as RGB, so plain channel-0 selection is exact."""
    if img.ndim == 2:
        return img
    return img[..., 0]


def pack_dataset(meta: pd.DataFrame, with_masks: bool = True
                 ) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Decode all rows of a metadata frame into packed arrays.

    Returns (images [N,101,101] uint8, masks [N,101,101] uint8 or None,
    depths [N] float32 = z/1000 as fed to depth-aware models, reference:
    loaders.py:310-311).
    """
    from salt_tpu_torch.data.native_png import pack_pngs
    img_paths = meta["file_path_image"].values
    images = pack_pngs(img_paths, 101, 101)         # native parallel decode
    if images is None:                              # fallback: PIL loop
        images = np.stack([to_grayscale(np.array(Image.open(p)))
                           for p in img_paths]).astype(np.uint8)
    masks = None
    if with_masks and "file_path_mask" in meta and meta["file_path_mask"].notna().all():
        mask_paths = meta["file_path_mask"].values
        masks = pack_pngs(mask_paths, 101, 101, mask_threshold=128)
        if masks is None:
            masks = np.stack(read_masks(mask_paths)).astype(np.uint8)
    depths = (meta["z"].values.astype(np.float32) / 1000.0)
    return images, masks, depths
