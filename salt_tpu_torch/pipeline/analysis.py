"""Error analysis over persisted predictions (counterpart of
``salt_tpu/pipeline/analysis.py``) — the reference's
`notebooks/result_exploration.ipynb` (score-by-mask-size breakdown,
empty-image confusion, threshold sensitivity) as a first-class
`analyze` CLI command instead of a manual notebook.

Reads an experiment's persisted probability artifacts
(`out_of_fold_train_predictions` from any *-cv run, else
`validation_predictions` from `evaluate`) and scores them against the
bundle's ground truth. Uses the numpy metrics only (metrics/iout.py,
reference: common_blocks/metrics.py): it touches no device, so it can
run beside a training process on the card.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from salt_tpu_torch.core.experiment import Experiment
from salt_tpu_torch.core.logging import get_logger
from salt_tpu_torch.data.bundle import DataBundle
from salt_tpu_torch.metrics.iout import (batch_iou_iout_np, compute_eval_metric,
                                   compute_ious)

logger = get_logger()

# gt mask-size buckets in pixels (101*101 = 10201 max); the reference
# notebook's score-by-size plot uses the same notion of "small masks
# are where IOUT is lost"
SIZE_BUCKETS = ((0, 0, "empty"),
                (1, 300, "tiny (1-300 px)"),
                (301, 1000, "small (301-1000 px)"),
                (1001, 3000, "medium (1001-3000 px)"),
                (3001, 10201, "large (3001+ px)"))

DEFAULT_THRESHOLDS = tuple(np.arange(0.30, 0.71, 0.05).round(2))


def _per_image_scores(y_true: np.ndarray, y_pred: np.ndarray
                      ) -> (List[float], List[float]):
    """Reference-semantics per-image loop. Kept as the parity oracle for
    the vectorized path (tests/test_torch_reports.py); production scoring
    goes through batch_iou_iout_np — one pass, no O(N) Python loop."""
    ious, iouts = [], []
    for t, p in zip(y_true, y_pred):
        m = compute_ious(t, p)
        ious.append(float(np.sum(m) / m.size))
        iouts.append(compute_eval_metric(t, p))
    return ious, iouts


def analyze_predictions(ids: Sequence[str], probs: np.ndarray,
                        bundle: DataBundle, threshold: float = 0.5,
                        thresholds: Sequence[float] = DEFAULT_THRESHOLDS
                        ) -> Dict:
    """Score probability maps [N,2,101,101] against the bundle's masks.

    Returns {overall, by_size, empty_confusion, threshold_curve}."""
    id_to_mask = {i: m for i, m in zip(bundle.meta["id"].tolist(),
                                       bundle.masks)}
    keep = [k for k, i in enumerate(ids) if i in id_to_mask]
    if not keep:
        raise ValueError(
            "no overlap between the persisted prediction ids and the "
            "bundle's ids — analyze must be run with the same data "
            "source (--synthetic N/seed or data dirs) the experiment "
            "was trained on")
    ids = [ids[k] for k in keep]
    probs = np.asarray(probs)[keep]
    y_true = np.stack([id_to_mask[i] for i in ids]).astype(np.uint8)
    fg = probs[:, 1]

    y_pred = (fg > threshold).astype(np.uint8)
    ious, iouts = batch_iou_iout_np(y_true, y_pred)
    n = len(ids)
    sizes = y_true.reshape(n, -1).sum(axis=1)

    by_size = {}
    for lo, hi, label in SIZE_BUCKETS:
        sel = (sizes >= lo) & (sizes <= hi)
        if not sel.any():
            continue
        by_size[label] = {"n": int(sel.sum()),
                          "iou": float(ious[sel].mean()),
                          "iout": float(iouts[sel].mean())}

    gt_empty = sizes == 0
    pred_empty = y_pred.reshape(n, -1).sum(axis=1) == 0
    empty_confusion = {
        "gt_empty_pred_empty": int((gt_empty & pred_empty).sum()),
        "gt_empty_pred_salt": int((gt_empty & ~pred_empty).sum()),
        "gt_salt_pred_empty": int((~gt_empty & pred_empty).sum()),
        "gt_salt_pred_salt": int((~gt_empty & ~pred_empty).sum()),
    }

    curve = {}
    for t in thresholds:
        if np.isclose(t, threshold):   # already scored above
            curve[f"{t:.2f}"] = float(iouts.mean())
            continue
        _, tis = batch_iou_iout_np(y_true, fg > t)
        curve[f"{t:.2f}"] = float(np.mean(tis))

    return {"n_images": n, "threshold": float(threshold),
            "overall": {"iou": float(ious.mean()),
                        "iout": float(iouts.mean())},
            "by_size": by_size,
            "empty_confusion": empty_confusion,
            "threshold_curve": curve}


def analyze_experiment(experiment: Experiment, bundle: DataBundle,
                       threshold: float = 0.5,
                       source: Optional[str] = None) -> Dict:
    """Analyze an experiment's persisted predictions (oof-CV if present,
    else the evaluate() validation predictions), persist analysis.json.
    """
    candidates = ([source] if source else
                  ["out_of_fold_train_predictions",
                   "validation_predictions"])
    name = next((c for c in candidates if experiment.has_output(c)), None)
    if name is None:
        raise FileNotFoundError(
            f"no prediction artifact in {experiment.directory} "
            f"(looked for {candidates}); run a *-cv or evaluate first")
    preds = experiment.load_predictions(name)
    report = analyze_predictions(preds["ids"], preds["images"], bundle,
                                 threshold)
    report["source"] = name
    experiment.save_json("analysis", report)
    return report


def format_report(report: Dict) -> str:
    lines = [f"source: {report['source']}  n={report['n_images']}  "
             f"threshold={report['threshold']:.2f}",
             f"overall     iou={report['overall']['iou']:.4f}  "
             f"iout={report['overall']['iout']:.4f}",
             "-- by gt mask size --"]
    for label, row in report["by_size"].items():
        lines.append(f"{label:<22} n={row['n']:<5} iou={row['iou']:.4f}  "
                     f"iout={row['iout']:.4f}")
    c = report["empty_confusion"]
    lines.append("-- empty-image confusion --")
    lines.append(f"gt empty : pred empty {c['gt_empty_pred_empty']}, "
                 f"pred salt {c['gt_empty_pred_salt']}")
    lines.append(f"gt salt  : pred empty {c['gt_salt_pred_empty']}, "
                 f"pred salt {c['gt_salt_pred_salt']}")
    lines.append("-- IOUT vs threshold --")
    lines.append("  ".join(f"{t}:{v:.4f}"
                           for t, v in report["threshold_curve"].items()))
    return "\n".join(lines)
