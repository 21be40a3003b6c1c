"""DataBundle: packed arrays + metadata, the unit the orchestration layer
consumes (own copy of ``salt_tpu/data/bundle.py``).

Replaces the reference's metadata-DataFrame -> XYSplit -> PNG-per-item
loader chain (reference: common_blocks/loaders.py:21-95,98-190) with a
decode-once packed representation. Supports the reference's DEV_MODE
subsampling (reference: main.py:40,469-471)."""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import pandas as pd

from salt_tpu_torch.core.config import Config
from salt_tpu_torch.data.images import pack_dataset


@dataclass
class DataBundle:
    meta: pd.DataFrame
    images: np.ndarray                 # [N, 101, 101] uint8
    masks: Optional[np.ndarray]        # [N, 101, 101] uint8 {0,1} or None
    depths: np.ndarray                 # [N] float32 (z / 1000)

    def __len__(self):
        return len(self.meta)

    def take(self, idx) -> "DataBundle":
        idx = np.asarray(idx)
        return DataBundle(
            meta=self.meta.iloc[idx].reset_index(drop=True),
            images=self.images[idx],
            masks=self.masks[idx] if self.masks is not None else None,
            depths=self.depths[idx])

    def dev_sample(self, n: int, seed: int = 1234) -> "DataBundle":
        """DEV_MODE subsample (reference: main.py:469-471 meta.sample)."""
        if n >= len(self):
            return self
        rng = np.random.RandomState(seed)
        return self.take(rng.choice(len(self), n, replace=False))


def _pack_cache_key(meta: pd.DataFrame, with_masks: bool) -> str:
    """Content key over the exact file set (paths + sizes + mtimes): any
    add/remove/replace — including an in-place edit that keeps the byte
    size — invalidates the cache."""
    import hashlib
    h = hashlib.sha1()
    cols = ["file_path_image"]
    if with_masks and "file_path_mask" in meta:
        cols.append("file_path_mask")
    for col in cols:
        for p in meta[col].values:
            try:
                st = os.stat(p)
                size, mtime = st.st_size, st.st_mtime_ns
            except (OSError, TypeError):
                size, mtime = -1, -1
            h.update(f"{p}:{size}:{mtime}\n".encode())
    return h.hexdigest()[:16]


def load_bundle(meta: pd.DataFrame, with_masks: bool = True,
                cache_dir: str = "") -> DataBundle:
    """Pack (or memmap a cached pack of) all rows of ``meta``.

    With ``cache_dir`` set the decoded uint8 arrays persist as .npy and
    later runs memmap them: the 6-fold flagship run on real TGS data
    starts in seconds instead of re-decoding 22k PNGs (ROADMAP
    real-data readiness; the reference re-decodes per __getitem__ per
    epoch, loaders.py:125-157)."""
    meta = meta.reset_index(drop=True)
    depths = (meta["z"].values.astype(np.float32) / 1000.0)
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        key = _pack_cache_key(meta, with_masks)
        img_p = os.path.join(cache_dir, f"pack_{key}_images.npy")
        msk_p = os.path.join(cache_dir, f"pack_{key}_masks.npy")
        if os.path.exists(img_p):
            images = np.load(img_p, mmap_mode="r")
            masks = (np.load(msk_p, mmap_mode="r")
                     if os.path.exists(msk_p) else None)
            return DataBundle(meta=meta, images=images, masks=masks,
                              depths=depths)
        images, masks, _ = pack_dataset(meta, with_masks=with_masks)
        np.save(img_p, images)
        if masks is not None:
            np.save(msk_p, masks)
        return DataBundle(meta=meta, images=images, masks=masks,
                          depths=depths)
    images, masks, _ = pack_dataset(meta, with_masks=with_masks)
    return DataBundle(meta=meta, images=images, masks=masks, depths=depths)


def train_test_bundles(config: Config, meta: Optional[pd.DataFrame] = None):
    """Load (train_bundle, test_bundle) from the metadata CSV contract
    (reference: main.py:455-456, 543-545)."""
    if meta is None:
        meta = pd.read_csv(config.paths.metadata_filepath)
    meta_train = meta[meta["is_train"] == 1]
    meta_test = meta[meta["is_train"] == 0]
    if config.execution.dev_mode:
        meta_train = meta_train.sample(
            min(config.execution.dev_mode_size, len(meta_train)),
            random_state=config.execution.seed)
        if len(meta_test):
            meta_test = meta_test.sample(
                min(config.execution.dev_mode_size, len(meta_test)),
                random_state=config.execution.seed)
    cache = config.execution.pack_cache_dir
    train = load_bundle(meta_train, with_masks=True, cache_dir=cache)
    test = (load_bundle(meta_test, with_masks=False, cache_dir=cache)
            if len(meta_test) else None)
    return train, test


def synthetic_bundle(n: int = 64, seed: int = 0,
                     with_masks: bool = True,
                     difficulty: str = "easy") -> DataBundle:
    """In-memory synthetic bundle for tests/benches."""
    from salt_tpu_torch.data.synthetic import synthetic_arrays, synthetic_metadata
    images, masks, depths = synthetic_arrays(n, seed=seed,
                                             difficulty=difficulty)
    meta = synthetic_metadata(images, masks, depths)
    return DataBundle(meta=meta, images=images,
                      masks=masks if with_masks else None,
                      depths=depths.astype(np.float32) / 1000.0)
