"""Distill a trained CV fold ensemble into a fast student, the
``distill`` command (counterpart of ``salt_tpu/pipeline/distill.py``).

The teacher's out-of-fold probabilities, persisted by every CV run as
``outputs/out_of_fold_train_predictions.npz`` (either package's), are
the soft targets: each image's probability comes from the fold that did
not train on it, so distillation needs no teacher inference. Flow: align
them to the first fold's train split, pack (hard mask, soft probability)
into uint16 targets, train the CONFIGURED model (the student, e.g.
``--set model.architecture=SaltUNet --set model.n_filters=16``) through
``fit`` with the distill loss (``train/distill.py``), score student and
teacher on the same held-out split, and write ``distill_report.json``
(with ``--measure-throughput`` also the student's TTA images/s on the
device, ``train/throughput.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from salt_tpu_torch.core.config import Config
from salt_tpu_torch.core.experiment import Experiment
from salt_tpu_torch.core.logging import get_logger
from salt_tpu_torch.data.bundle import DataBundle
from salt_tpu_torch.pipeline.api import (NETWORK, _binarize, _bundle_tuple,
                                         _first_fold, _make_callbacks,
                                         calculate_scores)
from salt_tpu_torch.train.distill import DistillRunner, pack_targets
from salt_tpu_torch.train.loop import fit

logger = get_logger()


def load_teacher_probs(teacher_dir: str, ids) -> np.ndarray:
    """Teacher salt probabilities aligned to ``ids`` (fp32 [N, 101, 101]
    in [0, 1]) from the CV run's persisted out-of-fold predictions."""
    teacher = Experiment(teacher_dir)
    if not teacher.has_output("out_of_fold_train_predictions"):
        raise FileNotFoundError(
            f"{teacher_dir} has no outputs/out_of_fold_train_predictions.npz"
            " — run a CV command (train-evaluate-cv / "
            "train-evaluate-predict-cv) there first")
    oof = teacher.load_predictions("out_of_fold_train_predictions")
    index = {i: k for k, i in enumerate(oof["ids"])}
    missing = [i for i in ids if i not in index]
    if missing:
        raise ValueError(
            f"teacher oof predictions cover {len(index)} ids but the "
            f"bundle needs {len(ids)}; first missing: {missing[:3]}")
    probs = np.asarray(oof["images"])[np.asarray([index[i] for i in ids])]
    if probs.ndim == 4:            # [N, 2, 101, 101] -> the salt channel
        probs = probs[:, 1]
    return np.clip(probs.astype(np.float32), 0.0, 1.0)


def _measure_student_throughput(runner, model) -> float:
    """The student's sustained hflip-TTA images/s on its device at the
    inference batch, with the bench's probe (``train/throughput.py``:
    inputs staged on the device, chained steps, one synchronization a
    window); serve's end-to-end rate, host preparation and copies
    included, is another metric."""
    from salt_tpu_torch.train.throughput import measure_tta_throughput
    return measure_tta_throughput(
        runner, model, runner.config.training.batch_size_inference)


def distill(config: Config, experiment: Experiment, bundle: DataBundle,
            teacher_dir: str, measure_throughput: bool = False,
            test_bundle: Optional[DataBundle] = None,
            device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    """Train the configured student on the teacher's soft targets on
    ``device``; report the quality delta on the teacher's held-out
    split."""
    runner = DistillRunner(config, device)
    train_idx, valid_idx = _first_fold(config, bundle)
    train_b, valid_b = bundle.take(train_idx), bundle.take(valid_idx)
    if config.execution.dev_mode:
        train_b = train_b.dev_sample(config.execution.dev_mode_size,
                                     config.execution.seed)
        valid_b = valid_b.dev_sample(config.execution.dev_mode_size // 2,
                                     config.execution.seed)

    t_train = load_teacher_probs(teacher_dir, train_b.meta["id"].tolist())
    t_valid = load_teacher_probs(teacher_dir, valid_b.meta["id"].tolist())
    packed = pack_targets(train_b.masks, t_train)

    use_depth = runner.use_depth
    callbacks = _make_callbacks(config, experiment, NETWORK, runner, valid_b)
    logger.info("distilling %s (alpha=%.2f) from teacher %s on %d images",
                config.model.architecture, config.training.distill_alpha,
                teacher_dir, len(train_b))
    fit(runner,
        (train_b.images, packed, train_b.depths if use_depth else None),
        _bundle_tuple(valid_b, use_depth),
        callbacks=callbacks, seed=config.execution.seed)

    # student and teacher on the same held-out split, same postprocessing
    model = runner.restore(experiment.load_params(NETWORK))
    probs = runner.predict_dataset(model, valid_b.images,
                                   valid_b.depths if use_depth else None,
                                   tta=config.postpro.use_tta)
    thr = config.postpro.threshold_masks
    y_true = list(valid_b.masks)
    s_iou, s_iout = calculate_scores(y_true, _binarize(probs, thr))
    t_pred = [(p > thr).astype(np.uint8) for p in t_valid]
    t_iou, t_iout = calculate_scores(y_true, t_pred)

    report = {
        "student_architecture": config.model.architecture,
        "distill_alpha": float(config.training.distill_alpha),
        "teacher_dir": teacher_dir,
        "n_train": int(len(train_b)), "n_valid": int(len(valid_b)),
        "student_iou": s_iou, "student_iout": s_iout,
        "teacher_iou": t_iou, "teacher_iout": t_iout,
        "iout_delta": s_iout - t_iout,
    }
    if measure_throughput:
        report["student_tta_images_per_sec"] = _measure_student_throughput(
            runner, model)
        logger.info("student TTA throughput: %.1f img/s",
                    report["student_tta_images_per_sec"])
    experiment.save_json("distill_report", report)
    logger.info("distill: student IOUT %.4f vs teacher %.4f (delta %+.4f)",
                s_iout, t_iout, s_iout - t_iout)

    if test_bundle is not None:
        from salt_tpu_torch.pipeline.api import predict
        predict(config, experiment, test_bundle, device=device)
    return report
