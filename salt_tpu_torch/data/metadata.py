"""Metadata generation (own copy of ``salt_tpu/data/metadata.py``): scans
the TGS data layout (``train/{images,masks}``, ``test/images``, a depths
CSV) and builds the ``metadata.csv`` contract that
``data/bundle.py::train_test_bundles`` loads.

Column contract (byte-compatible with reference:
common_blocks/utils.py:135-170): ``file_path_image, file_path_mask,
is_train, id, z, size, is_not_empty``; the stacking variant adds
``file_path_stacked_predictions`` (reference: utils.py:584-587).
"""
from __future__ import annotations

import os

import numpy as np
import pandas as pd
from PIL import Image

COLUMNS = ["file_path_image", "file_path_mask", "is_train", "id", "z",
           "size", "is_not_empty"]


def generate_metadata(train_images_dir: str, test_images_dir: str,
                      depths_filepath: str) -> pd.DataFrame:
    """One row per train image (its mask's salt pixel count as ``size``)
    and per test image (no mask: ``None`` / NaN), each with its depth
    ``z``; the test directory may be absent."""
    depths = pd.read_csv(depths_filepath).set_index("id")["z"]

    rows = []
    train_dir = os.path.join(train_images_dir, "images")
    for filename in sorted(os.listdir(train_dir)):
        image_id = filename.split(".")[0]
        mask_filepath = os.path.join(train_images_dir, "masks", filename)
        size = int((np.array(Image.open(mask_filepath)) > 0).sum())
        rows.append({
            "file_path_image": os.path.join(train_dir, filename),
            "file_path_mask": mask_filepath,
            "is_train": 1,
            "id": image_id,
            "z": depths.loc[image_id],
            "size": size,
            "is_not_empty": int(size != 0),
        })

    test_dir = os.path.join(test_images_dir, "images")
    if os.path.isdir(test_dir):
        for filename in sorted(os.listdir(test_dir)):
            image_id = filename.split(".")[0]
            rows.append({
                "file_path_image": os.path.join(test_dir, filename),
                "file_path_mask": None,
                "is_train": 0,
                "id": image_id,
                "z": depths.loc[image_id],
                "size": np.nan,
                "is_not_empty": np.nan,
            })

    return pd.DataFrame(rows, columns=COLUMNS)


def generate_metadata_stacking(metadata_filepath: str,
                               joined_predictions_dir: str,
                               colname: str = "file_path_stacked_predictions"
                               ) -> pd.DataFrame:
    """Add per-id stacked-prediction paths (reference: utils.py:584-587).
    Predictions are stored as npz cubes rather than joblib pickles."""
    meta = pd.read_csv(metadata_filepath)
    meta[colname] = meta["id"].apply(
        lambda x: os.path.join(joined_predictions_dir, f"{x}.npz"))
    return meta
