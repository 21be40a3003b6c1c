"""Auxiliary small-mask crop data (counterpart of
``salt_tpu/data/auxiliary.py``).

Capability counterpart of the reference's auxiliary-data workflow:
``get_cut_coordinates`` (reference: common_blocks/utils.py:527-557)
searches rotated corner crops containing a small amount of salt, the
small_mask_generation notebook materializes those crops as extra
training images, and USE_AUXILIARY_DATA concatenates the crops whose
SOURCE image lies in the fold's validation split into the fold's
training set (reference: main.py:464-467 — a different view of the
held-out images, not the images themselves).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import pandas as pd

from salt_tpu_torch.data.bundle import DataBundle


def get_cut_coordinates(mask: np.ndarray, step: int = 4,
                        min_img_crop: int = 20, min_size: int = 50,
                        max_size: int = 300
                        ) -> Tuple[Tuple[int, int], Tuple[int, int], bool]:
    """Find a corner crop whose salt content lies in (min_size, max_size]
    (reference: utils.py:527-557 — tries the four rotations, keeps the
    largest crop below 99 px)."""
    mask = np.asarray(mask)
    h, w = mask.shape
    ts = []
    rots = [1, 2, 3, 0]
    m = mask
    for rot in rots:
        m = np.rot90(m)
        t = min_img_crop
        for t in range(min_img_crop, h, step):
            crop = m[:t, :t]
            size = crop.mean() * h * w
            if min_size < size <= max_size:
                break
        ts.append((t, rot))
    ts = [(t, r) for t, r in ts if t < 99]
    if not ts:
        return (0, w), (0, h), False
    best_t, best_rot = sorted(ts, key=lambda x: x[0], reverse=True)[0]
    if best_t < min_img_crop:
        return (0, w), (0, h), False
    if best_rot == 0:
        x1, x2, y1, y2 = 0, best_t, 0, best_t
    elif best_rot == 1:
        x1, x2, y1, y2 = 0, best_t, h - best_t, h
    elif best_rot == 2:
        x1, x2, y1, y2 = w - best_t, w, h - best_t, h
    else:
        x1, x2, y1, y2 = w - best_t, w, 0, best_t
    return (x1, x2), (y1, y2), True


def _resize_u8(img: np.ndarray, size: int, is_mask: bool) -> np.ndarray:
    """Bilinear resize (``ops.preprocess.resize_hw``, JAX's
    ``jax.image.resize`` semantics) on the host, in fp32."""
    import torch

    from salt_tpu_torch.ops.preprocess import resize_hw
    x = torch.from_numpy(np.asarray(img, np.float32))[None]
    out = resize_hw(x, (size, size))[0].numpy()
    if is_mask:
        return (out > 0.5).astype(np.uint8)
    return np.clip(out, 0, 255).astype(np.uint8)


def generate_auxiliary_bundle(bundle: DataBundle, target_size: int = 101,
                              max_mask_size: int = 1000) -> DataBundle:
    """Build crops from images with small masks (the notebook's output,
    consumed by USE_AUXILIARY_DATA). Each auxiliary row keeps its source
    image's id in a ``source_id`` column so the fold logic can match it
    against the validation split."""
    images, masks, ids, zs, src = [], [], [], [], []
    for k in range(len(bundle)):
        mask = bundle.masks[k]
        size = int(mask.sum())
        if size == 0 or size > max_mask_size:
            continue
        (x1, x2), (y1, y2), ok = get_cut_coordinates(mask)
        if not ok or (x2 - x1) < 20 or (y2 - y1) < 20:
            continue
        img_c = bundle.images[k][y1:y2, x1:x2]
        msk_c = mask[y1:y2, x1:x2]
        if not msk_c.any():
            continue
        images.append(_resize_u8(img_c, target_size, is_mask=False))
        masks.append(_resize_u8(msk_c, target_size, is_mask=True))
        source = bundle.meta["id"].iloc[k]
        ids.append(f"aux_{source}")
        src.append(source)
        zs.append(bundle.meta["z"].iloc[k])
    if not images:
        empty = pd.DataFrame(columns=["file_path_image", "file_path_mask",
                                      "is_train", "id", "z", "size",
                                      "is_not_empty", "source_id"])
        return DataBundle(meta=empty,
                          images=np.zeros((0, target_size, target_size),
                                          np.uint8),
                          masks=np.zeros((0, target_size, target_size),
                                         np.uint8),
                          depths=np.zeros((0,), np.float32))
    images = np.stack(images)
    masks = np.stack(masks)
    sizes = masks.reshape(len(masks), -1).sum(axis=1)
    meta = pd.DataFrame({
        "file_path_image": [f"<aux>/{i}.png" for i in ids],
        "file_path_mask": [f"<aux>/m{i}.png" for i in ids],
        "is_train": 1,
        "id": ids,
        "z": zs,
        "size": sizes,
        "is_not_empty": (sizes > 0).astype(int),
        "source_id": src,
    })
    return DataBundle(meta=meta, images=images, masks=masks,
                      depths=np.asarray(zs, np.float32) / 1000.0)


def concat_bundles(a: DataBundle, b: DataBundle) -> DataBundle:
    if len(b) == 0:
        return a
    meta = pd.concat([a.meta, b.meta], axis=0,
                     ignore_index=True)
    return DataBundle(
        meta=meta,
        images=np.concatenate([a.images, b.images]),
        masks=(np.concatenate([a.masks, b.masks])
               if a.masks is not None and b.masks is not None else None),
        depths=np.concatenate([a.depths, b.depths]))


def auxiliary_rows_for_fold(aux: DataBundle, valid_ids) -> DataBundle:
    """Auxiliary crops whose source image is in the validation split
    (reference: main.py:465-467); none is an empty bundle (the JAX
    package's raises IndexError there: its empty index list is float)."""
    valid = set(valid_ids)
    keep = [k for k, s in enumerate(aux.meta["source_id"]) if s in valid]
    return aux.take(np.asarray(keep, np.int64))
