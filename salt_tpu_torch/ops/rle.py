"""Run-length encoding and Kaggle submission writing (numpy).

Own copy of ``salt_tpu/ops/rle.py`` (:44-95): column-major, 1-indexed
(start, length) pairs, any value > 0 counts as foreground.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import pandas as pd


def run_length_encoding(x: np.ndarray) -> List[int]:
    flat = (np.asarray(x) != 0).T.reshape(-1)
    padded = np.concatenate([[0], flat, [0]]).astype(np.int8)
    diffs = np.diff(padded)
    starts = np.flatnonzero(diffs == 1) + 1
    ends = np.flatnonzero(diffs == -1) + 1
    rle = np.empty(2 * starts.size, dtype=np.int64)
    rle[0::2] = starts
    rle[1::2] = ends - starts
    return rle.tolist()


def create_submission(meta: pd.DataFrame,
                      predictions: Sequence[np.ndarray]) -> pd.DataFrame:
    """The ``id, rle_mask`` submission frame."""
    rows = []
    for image_id, mask in zip(meta["id"].values, predictions):
        rle = " ".join(str(v) for v in run_length_encoding(mask))
        rows.append([image_id, rle])
    return pd.DataFrame(rows, columns=["id", "rle_mask"]).astype(str)
