"""Experiment orchestration: train / evaluate / predict / CV ensembles
(counterpart of ``salt_tpu/pipeline/api.py``).

- Single-fold train and evaluate use the FIRST depth-stratified fold
  (reference: main.py:458-462), with the reference's DEV_MODE subsampling.
- The CV loops train (or not) every fold into ``checkpoints/
  network_fold_<i>/``, then predict each fold's validation split and, with
  a test bundle, the test set from the fold's persisted ``best.npz``; the
  fold test probabilities are averaged before the threshold.
- Evaluation reloads the persisted best checkpoint rather than reusing
  in-memory weights; each fold's weights go to the device once.
- Checkpoints go under ``checkpoints/network/`` in the flat format both
  packages read; the full config is persisted as ``config.json`` so
  ``serve`` (either package's) rebuilds the trained network from the
  experiment dir alone.
- With the runner's ``use_depth`` (``execution.use_depth`` or a depth
  model), train, evaluate, predict and the CV loop hand each bundle's
  depths to the steps (JAX ``pipeline/api.py:59-60,98,209-220``).
- ``execution.resume`` continues from the ``last`` checkpoint (the
  port's own Adam state, or the optax Adam state of one the JAX package
  wrote), ``execution.fine_tuning`` restarts from ``best``.

- With ``model.quant_bits`` set the CV loop runs the int8 quality gate
  on every fold (``pipeline/quality.py``, JAX ``pipeline/api.py:309,
  351-362``): its validation probabilities are the int8 path's, and a
  float runner, made once at the first fold, predicts the same split.

- ``execution.use_auxiliary_data`` (JAX ``pipeline/api.py:165-178,
  232-240,310-313``): the small-mask crops (``data/auxiliary.py``) are
  generated once from the whole bundle, and each fit trains on its train
  split plus the crops whose source image is in its validation split
  (reference: main.py:464-467).

Not ported yet, raising ``NotImplementedError``: ``parallel.fold_parallel``
(ROADMAP.md Queue A item 17).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from salt_tpu_torch.core.config import Config
from salt_tpu_torch.core.experiment import Experiment, add_fold_suffix
from salt_tpu_torch.core.logging import get_logger
from salt_tpu_torch.data.bundle import DataBundle
from salt_tpu_torch.data.kfold import KFoldBySortedValue
from salt_tpu_torch.metrics.iout import batch_iou_iout
from salt_tpu_torch.models.convert import load_flax_flat
from salt_tpu_torch.ops.rle import create_submission
from salt_tpu_torch.train.callbacks import (CallbackList, ChannelLogger,
                                            EarlyStopping, ExperimentTiming,
                                            ExponentialLRScheduler,
                                            InitialLearningRateFinder,
                                            ModelCheckpoint,
                                            ReduceLROnPlateauScheduler,
                                            TrainingMonitor,
                                            ValidationImageMonitor)
from salt_tpu_torch.train.loop import fit
from salt_tpu_torch.train.state import TrainState
from salt_tpu_torch.train.steps import SegmentationRunner

logger = get_logger()

NETWORK = "network"


def _first_fold(config: Config, bundle: DataBundle):
    cv = KFoldBySortedValue(n_splits=config.execution.n_cv_splits)
    train_idx, valid_idx = next(iter(cv.split(bundle.meta["z"].values)))
    return train_idx, valid_idx


def _bundle_tuple(b: DataBundle, use_depth: bool
                  ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    return b.images, b.masks, (b.depths if use_depth else None)


def _lr_schedule_callbacks(t) -> List:
    """The scheduler callback the config selects (reference:
    models.py:300-312)."""
    schedule = (t.lr_schedule or "none").lower()
    if schedule == "plateau":
        return [ReduceLROnPlateauScheduler(t.validation_metric_name,
                                           t.minimize_validation_metric,
                                           t.reduce_factor,
                                           t.reduce_patience, t.min_lr)]
    if schedule == "exponential":
        return [ExponentialLRScheduler(t.gamma)]
    if schedule in ("lr_finder", "lr-finder"):
        return [InitialLearningRateFinder()]
    if schedule == "none":
        return []
    raise ValueError(f"unknown training.lr_schedule {t.lr_schedule!r} "
                     "(want plateau | exponential | lr_finder | none)")


def _make_callbacks(config: Config, experiment: Experiment, name: str,
                    runner: Optional[SegmentationRunner] = None,
                    valid_b: Optional[DataBundle] = None) -> CallbackList:
    # every fit passes through here once per trained model: persist the
    # config so serve rebuilds the trained architecture
    experiment.save_json("config", config.to_dict())
    t = config.training
    image_monitor = []
    if t.validation_images_every and runner is not None and valid_b is not None:
        # input|prediction|target triptychs (the JAX package's
        # pipeline/api.py:91-100)
        image_monitor = [ValidationImageMonitor(
            experiment.directory + f"/validation_images_{name}", runner,
            valid_b.images, valid_b.masks,
            valid_b.depths if runner.use_depth else None,
            image_nr=t.validation_image_nr,
            image_every=t.validation_images_every)]
    return CallbackList([
        ExperimentTiming(),
        TrainingMonitor(epoch_every=1),
        ModelCheckpoint(experiment, name,
                        metric_name=t.validation_metric_name,
                        minimize=t.minimize_validation_metric,
                        resume=config.execution.resume),
        *_lr_schedule_callbacks(t),
        EarlyStopping(t.validation_metric_name, t.patience,
                      t.minimize_validation_metric),
        *image_monitor,
        ChannelLogger(experiment.directory + f"/channels_{name}.jsonl"),
    ])


def _load_best(runner: SegmentationRunner, experiment: Experiment,
               name: str) -> TrainState:
    """A fresh train state holding the persisted best weights (either
    package's ``best.npz``), on the device once."""
    state = runner.init_state(runner.config.execution.seed)
    load_flax_flat(state.model, experiment.load_params(name))
    return state


def load_last(runner: SegmentationRunner, experiment: Experiment,
              name: str) -> Tuple[TrainState, int]:
    """Restore the crash-recovery checkpoint with the optimizer state;
    returns (state, next_epoch)."""
    state = runner.init_state(runner.config.execution.seed)
    arrays = experiment.load_params(name, tag="last")
    state.load_optimizer_arrays(arrays, experiment.checkpoint_path(name,
                                                                   "last"))
    load_flax_flat(state.model, {k: v for k, v in arrays.items()
                                 if k.startswith(("params/", "batch_stats/"))})
    meta = experiment.load_meta(name, tag="last")
    return state, int(meta.get("epoch", -1)) + 1


def _auxiliary(config: Config, bundle: DataBundle,
               aux: Optional[DataBundle]) -> Optional[DataBundle]:
    """The crops of ``bundle`` when ``execution.use_auxiliary_data`` asks
    for them and the caller gave none."""
    if config.execution.use_auxiliary_data and aux is None:
        from salt_tpu_torch.data.auxiliary import generate_auxiliary_bundle
        aux = generate_auxiliary_bundle(bundle)
        logger.info("generated %d auxiliary small-mask crops", len(aux))
    return aux


def _with_auxiliary(config: Config, train_b: DataBundle,
                    valid_b: DataBundle,
                    aux: Optional[DataBundle]) -> DataBundle:
    """USE_AUXILIARY_DATA: the train split plus the crops whose SOURCE
    image is in the validation split (reference: main.py:464-467)."""
    if not config.execution.use_auxiliary_data or aux is None or not len(aux):
        return train_b
    from salt_tpu_torch.data.auxiliary import (auxiliary_rows_for_fold,
                                               concat_bundles)
    picked = auxiliary_rows_for_fold(aux, valid_b.meta["id"].tolist())
    logger.info("auxiliary data: adding %d crops to the train split",
                len(picked))
    return concat_bundles(train_b, picked)


def _fit_fold(config: Config, experiment: Experiment, name: str,
              train_b: DataBundle, valid_b: DataBundle,
              runner: SegmentationRunner) -> SegmentationRunner:
    state = None
    start_epoch = 0
    if (config.execution.resume
            and experiment.train_finished(name, config.training.epochs)):
        logger.info("resume: %s training already finished, skipping fit",
                    name)
        return runner
    if (config.execution.resume
            and experiment.has_checkpoint(name, tag="last")):
        logger.info("resuming %s from the last checkpoint", name)
        state, start_epoch = load_last(runner, experiment, name)
        if start_epoch >= config.training.epochs:
            logger.info("resume: %s already at the epoch budget, "
                        "skipping fit", name)
            return runner
    elif config.execution.fine_tuning and experiment.has_checkpoint(name):
        logger.info("fine-tuning %s from persisted checkpoint", name)
        state = _load_best(runner, experiment, name)
    callbacks = _make_callbacks(config, experiment, name, runner, valid_b)
    fit(runner, _bundle_tuple(train_b, runner.use_depth),
        _bundle_tuple(valid_b, runner.use_depth), callbacks=callbacks,
        state=state, seed=config.execution.seed, start_epoch=start_epoch)
    return runner


def train(config: Config, experiment: Experiment, bundle: DataBundle,
          device: Union[str, torch.device] = "cuda",
          aux: Optional[DataBundle] = None) -> SegmentationRunner:
    """Single-fold training on the first depth-stratified fold
    (reference: main.py:454-488), on ``device`` (CUDA unless the caller
    asks for the CPU)."""
    runner = SegmentationRunner(config, device)
    aux = _auxiliary(config, bundle, aux)
    train_idx, valid_idx = _first_fold(config, bundle)
    train_b, valid_b = bundle.take(train_idx), bundle.take(valid_idx)
    train_b = _with_auxiliary(config, train_b, valid_b, aux)
    if config.execution.dev_mode:
        train_b = train_b.dev_sample(config.execution.dev_mode_size,
                                     config.execution.seed)
        valid_b = valid_b.dev_sample(config.execution.dev_mode_size // 2,
                                     config.execution.seed)
    return _fit_fold(config, experiment, NETWORK, train_b, valid_b, runner)


def _binarize(probs: np.ndarray, threshold: float) -> List[np.ndarray]:
    """Channel-1 thresholding (reference: postprocessing.py:41-43)."""
    return [(p[1] > threshold).astype(np.uint8) for p in probs]


def calculate_scores(y_true, y_pred) -> Tuple[float, float]:
    """(IoU, IOUT) over mask lists, fp32 per image as the JAX package's
    batched path computes them (reference: main.py:867-870)."""
    per_iou, per_iout = batch_iou_iout(torch.from_numpy(np.stack(y_true)),
                                       torch.from_numpy(np.stack(y_pred)))
    return float(np.mean(per_iou.numpy())), float(np.mean(per_iout.numpy()))


def _predict_bundles(runner: SegmentationRunner, experiment: Experiment,
                     name: str, *bundles: DataBundle) -> List[np.ndarray]:
    """The persisted best weights of ``name``, placed on the device once,
    over each of ``bundles``: fp32 [N, 2, 101, 101] each."""
    model = runner.restore(experiment.load_params(name))
    return [runner.predict_dataset(model, b.images,
                                   b.depths if runner.use_depth else None,
                                   tta=runner.config.postpro.use_tta)
            for b in bundles]


def evaluate(config: Config, experiment: Experiment, bundle: DataBundle,
             device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    """Evaluate the persisted model on the first fold's validation split
    (reference: main.py:491-537)."""
    _, valid_idx = _first_fold(config, bundle)
    valid_b = bundle.take(valid_idx)
    if config.execution.dev_mode:
        valid_b = valid_b.dev_sample(config.execution.dev_mode_size,
                                     config.execution.seed)
    runner = SegmentationRunner(config, device)
    probs, = _predict_bundles(runner, experiment, NETWORK, valid_b)
    y_pred = _binarize(probs, config.postpro.threshold_masks)
    iou, iout = calculate_scores(list(valid_b.masks), y_pred)
    logger.info("IOU score on validation is %s", iou)
    logger.info("IOUT score on validation is %s", iout)
    experiment.save_json("validation_results", {"iou": iou, "iout": iout})
    experiment.save_predictions("validation_predictions",
                                valid_b.meta["id"].tolist(), probs)
    return {"iou": iou, "iout": iout}


def _write_submission(experiment: Experiment, meta, masks) -> str:
    path = experiment.directory + "/submission.csv"
    create_submission(meta, masks).to_csv(path, index=None, encoding="utf-8")
    logger.info("submission saved to %s", path)
    return path


def predict(config: Config, experiment: Experiment, test_bundle: DataBundle,
            suffix: str = "",
            device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Predict the test set and write submission.csv
    (reference: main.py:540-575)."""
    if config.execution.dev_mode:
        test_bundle = test_bundle.dev_sample(config.execution.dev_mode_size,
                                             config.execution.seed)
    runner = SegmentationRunner(config, device)
    probs, = _predict_bundles(runner, experiment, NETWORK + suffix,
                              test_bundle)
    _write_submission(experiment, test_bundle.meta,
                      _binarize(probs, config.postpro.threshold_masks))
    return probs


def _cv_loop(config: Config, experiment: Experiment, bundle: DataBundle,
             test_bundle: Optional[DataBundle], do_train: bool,
             device: Union[str, torch.device] = "cuda",
             aux: Optional[DataBundle] = None) -> Dict:
    """Every fold: fit (``do_train``), predict its validation split and
    score it, predict the test bundle; then ``cv_scores.json``, the
    out-of-fold predictions and, with a test bundle, the submission
    (reference: main.py:578-863)."""
    if do_train and config.parallel.fold_parallel:
        raise NotImplementedError(
            "parallel.fold_parallel: training all folds at once is not "
            "ported yet (ROADMAP.md Queue A item 17)")
    if config.execution.dev_mode:
        bundle = bundle.dev_sample(config.execution.dev_mode_size,
                                   config.execution.seed)
        if test_bundle is not None:
            test_bundle = test_bundle.dev_sample(
                config.execution.dev_mode_size, config.execution.seed)
    cv = KFoldBySortedValue(n_splits=config.execution.n_cv_splits)
    fold_iou, fold_iout = [], []
    oof_ids: List[str] = []
    oof_images: List[np.ndarray] = []
    test_preds: List[np.ndarray] = []
    runner = SegmentationRunner(config, device)
    runner_fp = None                   # the int8 gate's float runner
    if do_train:
        aux = _auxiliary(config, bundle, aux)
    for fold_id, (train_idx, valid_idx) in enumerate(
            cv.split(bundle.meta["z"].values)):
        name = add_fold_suffix(NETWORK, fold_id)
        train_b, valid_b = bundle.take(train_idx), bundle.take(valid_idx)
        logger.info("Started fold %d", fold_id)
        if do_train:
            _fit_fold(config, experiment, name,
                      _with_auxiliary(config, train_b, valid_b, aux),
                      valid_b, runner)
        probs = _predict_bundles(runner, experiment, name, valid_b,
                                 *([] if test_bundle is None else [test_bundle]))
        probs_valid = probs[0]
        y_pred = _binarize(probs_valid, config.postpro.threshold_masks)
        iou, iout = calculate_scores(list(valid_b.masks), y_pred)
        logger.info("Fold %d IOU %s IOUT %s", fold_id, iou, iout)
        if config.model.quant_bits:
            from salt_tpu_torch.pipeline.quality import run_fold_int8_gate
            if runner_fp is None:
                runner_fp = SegmentationRunner(config.replace(
                    model=dataclasses.replace(config.model, quant_bits=0)),
                    device)
            run_fold_int8_gate(config, experiment, name, valid_b,
                               runner_fp, probs_valid)
        fold_iou.append(iou)
        fold_iout.append(iout)
        oof_ids.extend(valid_b.meta["id"].tolist())
        oof_images.extend(list(probs_valid))
        test_preds.extend(probs[1:])

    scores = {"iou_mean": float(np.mean(fold_iou)),
              "iou_std": float(np.std(fold_iou)),
              "iout_mean": float(np.mean(fold_iout)),
              "iout_std": float(np.std(fold_iout)),
              "fold_iou": fold_iou, "fold_iout": fold_iout}
    logger.info("IOU mean %s std %s; IOUT mean %s std %s",
                scores["iou_mean"], scores["iou_std"],
                scores["iout_mean"], scores["iout_std"])
    experiment.save_json("cv_scores", scores)
    if test_bundle is not None and test_preds:
        save_predictions(config, experiment, oof_ids, oof_images,
                         test_bundle, test_preds)
    elif oof_images:
        experiment.save_predictions("out_of_fold_train_predictions",
                                    oof_ids, np.stack(oof_images))
    return scores


def save_predictions(config: Config, experiment: Experiment,
                     oof_ids, oof_images, test_bundle: DataBundle,
                     test_preds: List[np.ndarray]) -> None:
    """Fold-mean test probabilities -> binarize -> submission; persist the
    out-of-fold train and test predictions (reference: main.py:892-913)."""
    averaged = np.mean(np.stack(test_preds), axis=0)   # [N, 2, 101, 101]
    experiment.save_predictions("out_of_fold_train_predictions",
                                oof_ids, np.stack(oof_images))
    experiment.save_predictions("out_of_fold_test_predictions",
                                test_bundle.meta["id"].tolist(), averaged)
    _write_submission(experiment, test_bundle.meta,
                      _binarize(averaged, config.postpro.threshold_masks))


def train_evaluate_cv(config, experiment, bundle, device="cuda"):
    return _cv_loop(config, experiment, bundle, None, True, device)


def train_evaluate_predict_cv(config, experiment, bundle, test_bundle,
                              device="cuda"):
    return _cv_loop(config, experiment, bundle, test_bundle, True, device)


def evaluate_cv(config, experiment, bundle, device="cuda"):
    return _cv_loop(config, experiment, bundle, None, False, device)


def evaluate_predict_cv(config, experiment, bundle, test_bundle,
                        device="cuda"):
    return _cv_loop(config, experiment, bundle, test_bundle, False, device)
