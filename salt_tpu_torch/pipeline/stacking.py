"""Stacking data and the second-level CV (counterpart of
``salt_tpu/pipeline/stacking.py``; reference: common_blocks/utils.py:
560-587, prepare_metadata.py:27-42, main.py:41,304-344).

First-level predictions are read from either package's
``outputs/out_of_fold_{train,test}_predictions.npz``; the joined
representation is one [N, 101, 101, M] cube per split (channel 1 of each
experiment's [2, H, W] prediction, one channel per experiment).
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from salt_tpu_torch.core.config import Config
from salt_tpu_torch.core.experiment import Experiment, add_fold_suffix
from salt_tpu_torch.core.logging import get_logger
from salt_tpu_torch.data.bundle import DataBundle
from salt_tpu_torch.data.kfold import KFoldBySortedValue
from salt_tpu_torch.ops.rle import create_submission

logger = get_logger()


def join_experiment_predictions(experiment_dirs: Sequence[str],
                                split: str = "train"
                                ) -> Tuple[List[str], np.ndarray]:
    """The experiments' out-of-fold ``split`` predictions joined into an
    fp32 [N, 101, 101, M] cube over their common ids, sorted
    (reference: utils.py:560-581)."""
    per_exp: List[Dict[str, np.ndarray]] = []
    for d in experiment_dirs:
        data = Experiment(d).load_predictions(
            f"out_of_fold_{split}_predictions")
        per_exp.append({i: img[1] for i, img in zip(data["ids"],
                                                    data["images"])})
    common_ids = sorted(set.intersection(*[set(p) for p in per_exp]))
    if not common_ids:
        raise ValueError("no common image ids across experiments")
    cube = np.stack([np.stack([p[i] for p in per_exp], axis=-1)
                     for i in common_ids])
    return common_ids, cube.astype(np.float32)


def stacking_bundle(bundle: DataBundle, ids: List[str],
                    cube: np.ndarray) -> Tuple[DataBundle, np.ndarray]:
    """The bundle's rows that the cube holds, in the bundle's order, and
    the cube's rows in that order."""
    id_to_row = {i: k for k, i in enumerate(ids)}
    keep = [k for k, i in enumerate(bundle.meta["id"]) if i in id_to_row]
    sub = bundle.take(keep)
    cube_rows = np.stack([cube[id_to_row[i]] for i in sub.meta["id"]])
    return sub, cube_rows


def train_evaluate_stacking(config: Config, experiment: Experiment,
                            bundle: DataBundle, cube: np.ndarray,
                            test_cube: Optional[np.ndarray] = None,
                            test_bundle: Optional[DataBundle] = None,
                            device: Union[str, torch.device] = "cuda"
                            ) -> Dict:
    """CV train / evaluate (and predict) of the StackingFCN second level
    on ``device``; ``cube`` [N, 101, 101, M] aligned with ``bundle``.
    ``training.stacking_epochs`` / ``stacking_lr`` set its own epochs and
    learning rate (the reference trains it to plateau). Writes
    ``stacking_cv_scores.json`` and, with a test cube,
    ``stacking_submission.csv``."""
    from salt_tpu_torch.pipeline.api import (_binarize, _make_callbacks,
                                             calculate_scores, load_last)
    from salt_tpu_torch.train.loop import fit
    from salt_tpu_torch.train.stacking import StackingRunner

    # a copy first: the runner sets the copy's loader_mode
    cfg = copy.deepcopy(config)
    cfg.model.architecture = ("StackingFCNWithDepth"
                              if config.execution.use_depth
                              else "StackingFCN")
    cfg.model.input_model_nr = cube.shape[-1]
    if cfg.training.stacking_epochs is not None:
        cfg.training.epochs = cfg.training.stacking_epochs
    if cfg.training.stacking_lr is not None:
        cfg.training.lr = cfg.training.stacking_lr
    runner = StackingRunner(cfg, device)
    use_depth = runner.use_depth

    cv = KFoldBySortedValue(n_splits=cfg.execution.n_cv_splits)
    fold_iou, fold_iout = [], []
    test_preds = []
    for fold_id, (train_idx, valid_idx) in enumerate(
            cv.split(bundle.meta["z"].values)):
        name = add_fold_suffix("stacking_network", fold_id)
        train_b, valid_b = bundle.take(train_idx), bundle.take(valid_idx)
        if (cfg.execution.resume
                and experiment.train_finished(name, cfg.training.epochs)):
            logger.info("resume: %s training already finished, "
                        "skipping fit", name)
        else:
            state0, start_epoch = None, 0
            if (cfg.execution.resume
                    and experiment.has_checkpoint(name, tag="last")):
                logger.info("resuming %s from the last checkpoint", name)
                state0, start_epoch = load_last(runner, experiment, name)
            if start_epoch < cfg.training.epochs:
                fit(runner,
                    (cube[train_idx], train_b.masks,
                     train_b.depths if use_depth else None),
                    (cube[valid_idx], valid_b.masks,
                     valid_b.depths if use_depth else None),
                    callbacks=_make_callbacks(cfg, experiment, name),
                    seed=cfg.execution.seed, state=state0,
                    start_epoch=start_epoch)
        model = runner.restore(experiment.load_params(name))
        probs = runner.predict_dataset(
            model, cube[valid_idx], valid_b.depths if use_depth else None)
        y_pred = _binarize(probs, cfg.postpro.threshold_masks)
        iou, iout = calculate_scores(list(valid_b.masks), y_pred)
        logger.info("Stacking fold %d IOU %s IOUT %s", fold_id, iou, iout)
        fold_iou.append(iou)
        fold_iout.append(iout)
        if test_cube is not None:
            test_preds.append(runner.predict_dataset(
                model, test_cube,
                test_bundle.depths if (use_depth and test_bundle is not None)
                else None))

    scores = {"iou_mean": float(np.mean(fold_iou)),
              "iout_mean": float(np.mean(fold_iout)),
              "fold_iou": fold_iou, "fold_iout": fold_iout}
    experiment.save_json("stacking_cv_scores", scores)
    if test_preds and test_bundle is not None:
        averaged = np.mean(np.stack(test_preds), axis=0)
        submission = create_submission(
            test_bundle.meta, _binarize(averaged, cfg.postpro.threshold_masks))
        path = experiment.directory + "/stacking_submission.csv"
        submission.to_csv(path, index=None, encoding="utf-8")
        logger.info("stacking submission saved to %s", path)
    return scores
