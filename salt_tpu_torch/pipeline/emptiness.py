"""Empty-vs-non-empty orchestration and two-stage gating (counterpart of
``salt_tpu/pipeline/emptiness.py``; reference: empty_vs_non_empty.py):
AUC-scored train / evaluate and CV loops over the EmptinessClassifier on
``device``, out-of-fold probability persistence under the JAX artifact
names, and the gating in which the classifier's P(non-empty) zeroes the
segmentation masks of images it calls empty.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from salt_tpu_torch.core.config import Config
from salt_tpu_torch.core.experiment import Experiment, add_fold_suffix
from salt_tpu_torch.core.logging import get_logger
from salt_tpu_torch.data.bundle import DataBundle
from salt_tpu_torch.data.kfold import KFoldBySortedValue
from salt_tpu_torch.metrics.auc import roc_auc
from salt_tpu_torch.pipeline.api import _first_fold
from salt_tpu_torch.train.callbacks import (CallbackList, ChannelLogger,
                                            EarlyStopping, ExperimentTiming,
                                            ModelCheckpoint,
                                            ReduceLROnPlateauScheduler,
                                            TrainingMonitor)
from salt_tpu_torch.train.classifier import ClassifierRunner, fit_classifier

logger = get_logger()

NETWORK = "emptiness"

Device = Union[str, torch.device]


def _labels(bundle: DataBundle) -> np.ndarray:
    return bundle.meta["is_not_empty"].values.astype(np.float32)


def _classifier_config(config: Config) -> Config:
    cfg = copy.deepcopy(config)
    cfg.model.architecture = "EmptinessClassifier"
    cfg.training.validation_metric_name = "auc"
    cfg.training.minimize_validation_metric = False
    return cfg


def _callbacks(cfg: Config, experiment: Experiment, name: str) -> CallbackList:
    experiment.save_json("config", cfg.to_dict())   # see api._make_callbacks
    t = cfg.training
    return CallbackList([
        ExperimentTiming(),
        TrainingMonitor(epoch_every=1),
        ModelCheckpoint(experiment, name, metric_name="auc", minimize=False,
                        resume=cfg.execution.resume),
        ReduceLROnPlateauScheduler("auc", False, t.reduce_factor,
                                   t.reduce_patience, t.min_lr),
        EarlyStopping("auc", t.patience, False),
        ChannelLogger(experiment.directory + f"/channels_{name}.jsonl"),
    ])


def train(config: Config, experiment: Experiment, bundle: DataBundle,
          device: Device = "cuda") -> ClassifierRunner:
    """First-fold training (reference: empty_vs_non_empty.py:374-416)."""
    cfg = _classifier_config(config)
    train_idx, valid_idx = _first_fold(cfg, bundle)
    train_b, valid_b = bundle.take(train_idx), bundle.take(valid_idx)
    runner = ClassifierRunner(cfg, device)
    fit_classifier(runner, (train_b.images, _labels(train_b)),
                   (valid_b.images, _labels(valid_b)),
                   callbacks=_callbacks(cfg, experiment, NETWORK),
                   seed=cfg.execution.seed)
    return runner


def evaluate(config: Config, experiment: Experiment, bundle: DataBundle,
             device: Device = "cuda") -> Dict[str, float]:
    """AUC of the persisted first-fold classifier on its validation
    split (``emptiness_validation_results.json``)."""
    cfg = _classifier_config(config)
    _, valid_idx = _first_fold(cfg, bundle)
    valid_b = bundle.take(valid_idx)
    runner = ClassifierRunner(cfg, device)
    model = runner.restore(experiment.load_params(NETWORK))
    probs = runner.predict_dataset(model, valid_b.images)
    auc = roc_auc(_labels(valid_b), probs[:, 1])
    logger.info("AUC score on validation is %s", auc)
    experiment.save_json("emptiness_validation_results", {"auc": auc})
    return {"auc": auc}


def _cv_loop(config: Config, experiment: Experiment, bundle: DataBundle,
             test_bundle: Optional[DataBundle], do_train: bool,
             device: Device = "cuda") -> Dict:
    """CV over the classifier: optional per-fold training, AUC scoring of
    the persisted fold checkpoints, out-of-fold train / fold-mean test
    probabilities (reference: empty_vs_non_empty.py:419-463 trained,
    466-535 eval-only, 560-628 eval and predict, 660-670 persistence).
    Each fold's best weights go to the device once."""
    cfg = _classifier_config(config)
    cv = KFoldBySortedValue(n_splits=cfg.execution.n_cv_splits)
    fold_auc: List[float] = []
    oof_ids: List[str] = []
    oof_probs: List[np.ndarray] = []
    test_probs: List[np.ndarray] = []
    runner = ClassifierRunner(cfg, device)

    for fold_id, (train_idx, valid_idx) in enumerate(
            cv.split(bundle.meta["z"].values)):
        name = add_fold_suffix(NETWORK, fold_id)
        valid_b = bundle.take(valid_idx)
        logger.info("Started emptiness fold %d", fold_id)
        if do_train:
            if (cfg.execution.resume
                    and experiment.train_finished(name,
                                                  cfg.training.epochs)):
                # fold-level crash recovery (a classifier fold restarts
                # from scratch otherwise, as in JAX)
                logger.info("resume: %s training already finished, "
                            "skipping fit", name)
            else:
                train_b = bundle.take(train_idx)
                fit_classifier(runner, (train_b.images, _labels(train_b)),
                               (valid_b.images, _labels(valid_b)),
                               callbacks=_callbacks(cfg, experiment, name),
                               seed=cfg.execution.seed)
        model = runner.restore(experiment.load_params(name))
        probs_valid = runner.predict_dataset(model, valid_b.images)
        auc = roc_auc(_labels(valid_b), probs_valid[:, 1])
        logger.info("Fold %d AUC %s", fold_id, auc)
        fold_auc.append(auc)
        oof_ids.extend(valid_b.meta["id"].tolist())
        oof_probs.extend(list(probs_valid))
        if test_bundle is not None:
            test_probs.append(runner.predict_dataset(model,
                                                     test_bundle.images))

    scores = {"auc_mean": float(np.mean(fold_auc)),
              "auc_std": float(np.std(fold_auc)), "fold_auc": fold_auc}
    logger.info("AUC mean %s std %s", scores["auc_mean"], scores["auc_std"])
    experiment.save_json("emptiness_cv_scores", scores)
    experiment.save_predictions("emptiness_oof_train_predictions",
                                oof_ids, np.stack(oof_probs))
    if test_probs:
        averaged = np.mean(np.stack(test_probs), axis=0)
        experiment.save_predictions("emptiness_oof_test_predictions",
                                    test_bundle.meta["id"].tolist(), averaged)
    return scores


def train_evaluate_predict_cv(config: Config, experiment: Experiment,
                              bundle: DataBundle,
                              test_bundle: Optional[DataBundle] = None,
                              device: Device = "cuda") -> Dict:
    """Full CV over the classifier (reference:
    empty_vs_non_empty.py:419-463,660-670)."""
    return _cv_loop(config, experiment, bundle, test_bundle, True, device)


def evaluate_cv(config: Config, experiment: Experiment, bundle: DataBundle,
                device: Device = "cuda") -> Dict:
    """Eval-only CV over persisted fold classifiers (reference:
    empty_vs_non_empty.py:466-535)."""
    return _cv_loop(config, experiment, bundle, None, False, device)


def evaluate_predict_cv(config: Config, experiment: Experiment,
                        bundle: DataBundle, test_bundle: DataBundle,
                        device: Device = "cuda") -> Dict:
    """Eval persisted fold classifiers and average their test
    probabilities (reference: empty_vs_non_empty.py:560-628)."""
    return _cv_loop(config, experiment, bundle, test_bundle, False, device)


def resize_emptiness_predictions(probs: np.ndarray,
                                 target_size=(101, 101)) -> np.ndarray:
    """Per-image class probabilities [N, 2] -> constant [N, 2, H, W] maps
    (reference: postprocessing.py:46-61)."""
    probs = np.asarray(probs)
    out = np.zeros((probs.shape[0], 2, *target_size), probs.dtype)
    out[:, 0] = probs[:, 0, None, None]
    out[:, 1] = probs[:, 1, None, None]
    return out


def apply_emptiness_gating(seg_probs: np.ndarray,
                           emptiness_probs: np.ndarray,
                           threshold: float = 0.5) -> np.ndarray:
    """Zero the salt probabilities of images whose P(non-empty)
    ``emptiness_probs`` [N] is under ``threshold`` (background set to 1
    there); ``seg_probs`` [N, 2, 101, 101]."""
    gate = (np.asarray(emptiness_probs) >= threshold).astype(seg_probs.dtype)
    out = seg_probs.copy()
    out[:, 1] *= gate[:, None, None]
    out[:, 0] = np.maximum(out[:, 0], 1.0 - gate[:, None, None])
    return out
