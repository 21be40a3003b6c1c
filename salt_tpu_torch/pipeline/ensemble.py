"""Cross-experiment prediction averaging (counterpart of
``salt_tpu/pipeline/ensemble.py``) — the reference's
`notebooks/prediction_average.ipynb` (how solutions 6-9 combined
independently trained experiments) as a first-class `ensemble` CLI
command.

Averages the persisted fold-mean test probabilities of N experiment
dirs (optionally weighted, mean or gmean — the same aggregations the
TTA aggregator supports, reference: loaders.py:728-735) into one
submission; when ground-truth masks are available it also scores the
averaged out-of-fold TRAIN predictions so the ensemble's CV gain over
its members is a measured number (reference: main.py:893 np.mean over
fold predictions; the notebook extends it across experiments).

Numpy only: it touches no device.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from salt_tpu_torch.core.experiment import Experiment
from salt_tpu_torch.core.logging import get_logger
from salt_tpu_torch.data.bundle import DataBundle

logger = get_logger()


def _load_aligned(dirs: Sequence[str], name: str):
    """Load `name` from every experiment, aligned to the id order of the
    first; ids missing from any experiment are dropped (logged)."""
    preds = [Experiment(d).load_predictions(name) for d in dirs]
    common = set(preds[0]["ids"])
    for p in preds[1:]:
        common &= set(p["ids"])
    ids = [i for i in preds[0]["ids"] if i in common]
    dropped = len(preds[0]["ids"]) - len(ids)
    if dropped:
        logger.info("ensemble: dropped %d ids not present in every "
                    "experiment", dropped)
    if not ids:
        raise ValueError(
            f"no common ids across experiments for {name!r} — the "
            "member experiments predict disjoint datasets")
    stacks = []
    for p in preds:
        index = {i: k for k, i in enumerate(p["ids"])}
        stacks.append(np.asarray(p["images"])[[index[i] for i in ids]])
    return ids, np.stack(stacks)   # [M, N, 2, H, W]


def average_probabilities(stacked: np.ndarray,
                          weights: Optional[Sequence[float]] = None,
                          method: str = "mean") -> np.ndarray:
    """Weighted mean / gmean over the experiment axis [M, ...] -> [...]."""
    m = stacked.shape[0]
    w = np.ones(m) if weights is None else np.asarray(weights, np.float64)
    if len(w) != m:
        raise ValueError(f"{len(w)} weights for {m} experiments")
    if w.sum() <= 0 or (w < 0).any():
        raise ValueError(
            f"ensemble weights must be non-negative with a positive sum, "
            f"got {w.tolist()} — a zero/negative normalizer would write "
            "an all-NaN (all-empty-mask) submission")
    w = w / w.sum()
    if method == "mean":
        return np.tensordot(w, stacked, axes=1)
    if method == "gmean":
        log = np.log(np.clip(stacked, 1e-7, 1.0))
        return np.exp(np.tensordot(w, log, axes=1))
    raise ValueError(f"unknown ensemble method: {method!r}")


def ensemble_experiments(experiment_dirs: Sequence[str], out_path: str,
                         train_bundle: Optional[DataBundle] = None,
                         weights: Optional[Sequence[float]] = None,
                         method: str = "mean",
                         threshold: float = 0.5) -> Dict:
    """Write the averaged-submission CSV; score oof train preds of each
    member and of the ensemble when ground truth is available."""
    import pandas as pd
    from salt_tpu_torch.ops.rle import create_submission

    result: Dict = {"experiments": list(experiment_dirs), "method": method}

    ids, stacked = _load_aligned(experiment_dirs,
                                 "out_of_fold_test_predictions")
    averaged = average_probabilities(stacked, weights, method)
    y_pred = [(img[1] > threshold).astype(np.uint8) for img in averaged]
    submission = create_submission(pd.DataFrame({"id": ids}), y_pred)
    submission.to_csv(out_path, index=None, encoding="utf-8")
    result["submission_path"] = out_path
    logger.info("ensemble submission (%d experiments, %s) -> %s",
                len(experiment_dirs), method, out_path)

    if train_bundle is not None and train_bundle.masks is not None:
        # Scoring is a best-effort diagnostic: the submission above is
        # already on disk, so a member missing its oof artifact (or a
        # bundle/artifact id mismatch) must not fail the command.
        try:
            result.update(_score_oof(experiment_dirs, train_bundle,
                                     weights, method, threshold))
        except (FileNotFoundError, KeyError, ValueError) as e:
            logger.info("ensemble: oof scoring skipped (%s)", e)
            result["oof_scoring_error"] = str(e)
    return result


def _score_oof(experiment_dirs: Sequence[str], train_bundle: DataBundle,
               weights: Optional[Sequence[float]], method: str,
               threshold: float) -> Dict:
    """Member vs ensemble oof IOUT by the numpy metrics
    (metrics/iout.py)."""
    from salt_tpu_torch.metrics.iout import \
        intersection_over_union_thresholds
    t_ids, t_stacked = _load_aligned(experiment_dirs,
                                     "out_of_fold_train_predictions")
    id_to_mask = {i: m for i, m in
                  zip(train_bundle.meta["id"].tolist(),
                      train_bundle.masks)}
    keep = [k for k, i in enumerate(t_ids) if i in id_to_mask]
    if not keep:
        raise ValueError("no overlap between oof prediction ids and the "
                         "train bundle — wrong --synthetic N/seed or "
                         "data dir?")
    t_ids = [t_ids[k] for k in keep]
    t_stacked = t_stacked[:, keep]
    y_true = [id_to_mask[i] for i in t_ids]
    member_scores = []
    for m in range(t_stacked.shape[0]):
        pred = [(p[1] > threshold).astype(np.uint8)
                for p in t_stacked[m]]
        member_scores.append(
            intersection_over_union_thresholds(y_true, pred))
    avg = average_probabilities(t_stacked, weights, method)
    pred = [(p[1] > threshold).astype(np.uint8) for p in avg]
    ens_iout = intersection_over_union_thresholds(y_true, pred)
    logger.info("oof IOUT: members %s -> ensemble %.5f",
                [round(s, 5) for s in member_scores], ens_iout)
    return {"member_oof_iout": member_scores,
            "ensemble_oof_iout": ens_iout}
