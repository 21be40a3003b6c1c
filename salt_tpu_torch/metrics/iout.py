"""IoU and IOUT, the Kaggle TGS metric (mAP of mask IoU over thresholds
0.50:0.05:0.95); counterpart of ``salt_tpu/metrics/iout.py``.

- The numpy functions are own copies of the JAX package's (:34-99,
  :143-166): the reference semantics, with the empty-mask edge cases
  (empty vs empty -> 1, one side empty -> 0).
- :func:`batch_iou_iout` is the torch twin of its jitted batched path
  (:106-134): every image and every threshold in one pass on the
  tensors' device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

IOUT_THRESHOLDS = tuple(np.arange(0.5, 1.0, 0.05).round(2))  # 0.5 ... 0.95


def iou(gt: np.ndarray, pred: np.ndarray) -> float:
    """Plain binary IoU; union==0 guarded with 1e-9."""
    gt = (np.asarray(gt) > 0).astype(np.float64)
    pred = (np.asarray(pred) > 0).astype(np.float64)
    intersection = np.sum(gt * pred)
    union = np.sum(np.clip(gt + pred, 0, 1))
    if union == 0:
        union = 1e-09
    return float(intersection / union)


def compute_ious(gt: np.ndarray, predictions: np.ndarray) -> np.ndarray:
    """The 1x1 IoU matrix of binary masks, with the reference's
    empty-mask edge cases."""
    gt = np.asarray(gt) > 0
    pred = np.asarray(predictions) > 0
    gt_empty = not gt.any()
    pred_empty = not pred.any()
    if gt_empty and pred_empty:
        return np.ones((1, 1))
    if gt_empty or pred_empty:
        return np.zeros((1, 1))
    inter = np.sum(gt & pred, dtype=np.float64)
    union = np.sum(gt | pred, dtype=np.float64)
    return np.array([[inter / union]])


def compute_precision_at(ious: np.ndarray, threshold: float) -> float:
    """TP / (TP + FP + FN) at an IoU threshold."""
    mx1 = np.max(ious, axis=0)
    mx2 = np.max(ious, axis=1)
    tp = np.sum(mx2 >= threshold)
    fp = np.sum(mx2 < threshold)
    fn = np.sum(mx1 < threshold)
    return float(tp) / (tp + fp + fn)


def compute_eval_metric(gt: np.ndarray, predictions: np.ndarray) -> float:
    """Per-image IOUT: the mean precision over the thresholds."""
    ious = compute_ious(gt, predictions)
    precisions = [compute_precision_at(ious, th) for th in IOUT_THRESHOLDS]
    return sum(precisions) / len(precisions)


def intersection_over_union(y_true: Sequence[np.ndarray],
                            y_pred: Sequence[np.ndarray]) -> float:
    """Mean IoU over a dataset."""
    ious = []
    for y_t, y_p in zip(y_true, y_pred):
        m = compute_ious(y_t, y_p)
        ious.append(np.sum(m) / len(m))
    return float(np.mean(ious))


def intersection_over_union_thresholds(y_true: Sequence[np.ndarray],
                                       y_pred: Sequence[np.ndarray]) -> float:
    """Mean IOUT over a dataset."""
    return float(np.mean([compute_eval_metric(t, p)
                          for t, p in zip(y_true, y_pred)]))


def batch_iou_iout(gt: torch.Tensor, pred: torch.Tensor):
    """Per-image (iou [B], iout [B]) fp32 of binary [B, H, W] masks (any
    numeric dtype), on their device."""
    gt = gt > 0
    pred = pred > 0
    inter = (gt & pred).sum(dim=(1, 2)).to(torch.float32)
    union = (gt | pred).sum(dim=(1, 2)).to(torch.float32)
    both_empty = ~gt.flatten(1).any(dim=1) & ~pred.flatten(1).any(dim=1)
    iou_val = torch.where(union > 0, inter / torch.clamp(union, min=1.0), 0.0)
    per_image_iou = torch.where(both_empty, 1.0, iou_val)
    thresholds = torch.tensor(IOUT_THRESHOLDS, dtype=torch.float32,
                              device=gt.device)
    hits = (iou_val[:, None] >= thresholds[None, :]).to(torch.float32)
    per_image_iout = torch.where(both_empty, 1.0, hits.mean(dim=1))
    return per_image_iou, per_image_iout


def batch_iou_iout_np(gt: np.ndarray, pred: np.ndarray):
    """Numpy twin of :func:`batch_iou_iout`, float64, per image."""
    gt = np.asarray(gt) > 0
    pred = np.asarray(pred) > 0
    n = gt.shape[0]
    g = gt.reshape(n, -1)
    p = pred.reshape(n, -1)
    inter = (g & p).sum(axis=1, dtype=np.float64)
    union = (g | p).sum(axis=1, dtype=np.float64)
    both_empty = ~g.any(axis=1) & ~p.any(axis=1)
    iou_val = np.where(union > 0, inter / np.maximum(union, 1.0), 0.0)
    per_iou = np.where(both_empty, 1.0, iou_val)
    th = np.asarray(IOUT_THRESHOLDS, dtype=np.float64)
    hits = (iou_val[:, None] >= th[None, :]).mean(axis=1)
    per_iout = np.where(both_empty, 1.0, hits)
    return per_iou, per_iout
