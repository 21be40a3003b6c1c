"""COCO-style RLE and connected-component segmentations (counterpart of
``salt_tpu/ops/coco_rle.py``; reference: common_blocks/utils.py:288-305
``rle_from_binary`` / ``binary_from_rle`` / ``get_segmentations``,
metrics.py:21-34 pairwise IoU over segment lists), without pycocotools:
COCO's uncompressed RLE of a binary mask is the column-major run-length
sequence starting with a background run. Numpy and scipy only.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def rle_from_binary(mask: np.ndarray) -> Dict:
    """Binary [H, W] mask -> ``{'size': [H, W], 'counts': [runs...]}``
    (column-major, the first run background, possibly of length 0)."""
    mask = np.asarray(mask) != 0
    h, w = mask.shape
    flat = mask.T.reshape(-1)
    change = np.flatnonzero(np.diff(flat.astype(np.int8))) + 1
    boundaries = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(boundaries).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    if not flat.size:
        counts = [0]
    return {"size": [h, w], "counts": counts}


def binary_from_rle(rle: Dict) -> np.ndarray:
    """Inverse of :func:`rle_from_binary`."""
    h, w = rle["size"]
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for run in rle["counts"]:
        if val:
            flat[pos:pos + run] = 1
        pos += run
        val ^= 1
    return flat.reshape(w, h).T


def label_components(mask: np.ndarray) -> np.ndarray:
    """4-connected component labels of a binary mask."""
    from scipy import ndimage
    labeled, _ = ndimage.label(np.asarray(mask) != 0)
    return labeled


def get_segmentations(labeled: np.ndarray) -> List[Dict]:
    """Integer-labeled mask -> one COCO RLE per label 1..max."""
    labeled = np.asarray(labeled)
    return [rle_from_binary((labeled == i).astype(np.uint8))
            for i in range(1, int(labeled.max()) + 1)]


def iou_matrix(gt_segments: List[Dict], pred_segments: List[Dict]
               ) -> np.ndarray:
    """Pairwise IoU, rows ground truth and columns predictions (the
    reference calls ``cocomask.iou(gt, preds)``, iscrowd 0)."""
    if not gt_segments or not pred_segments:
        return np.zeros((0, 0))
    gts = [binary_from_rle(r).astype(bool) for r in gt_segments]
    prs = [binary_from_rle(r).astype(bool) for r in pred_segments]
    out = np.zeros((len(gts), len(prs)))
    for i, g in enumerate(gts):
        for j, p in enumerate(prs):
            inter = np.logical_and(g, p).sum()
            union = np.logical_or(g, p).sum()
            out[i, j] = inter / union if union else 0.0
    return out
