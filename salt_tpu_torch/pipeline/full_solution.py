"""The composed solution (counterpart of
``salt_tpu/pipeline/full_solution.py``): segmentation CV ensemble ->
emptiness-classifier CV -> optional stacking second level -> one gated
``final_submission.csv``, every stage on ``device``.

The reference's highest-scoring configuration: the SECOND_LEVEL stacking
entry point (reference: main.py:304-344) fed by first-level out-of-fold
predictions, and the solution-9 gating in which the classifier's
out-of-fold P(non-empty) zeroes the masks of predicted-empty images
(SURVEY.md C15). The gating's effect is measured on the out-of-fold
train predictions (``gating_scores.json``).
"""
from __future__ import annotations

import copy
import json
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from salt_tpu_torch.core.config import Config
from salt_tpu_torch.core.experiment import Experiment, _atomic_write_text
from salt_tpu_torch.core.logging import get_logger
from salt_tpu_torch.data.bundle import DataBundle
from salt_tpu_torch.ops.rle import create_submission
from salt_tpu_torch.pipeline import api, emptiness, stacking

logger = get_logger()


def _stage_config(cfg: Config, workdir: str, stage: str) -> Config:
    stage_cfg = copy.deepcopy(cfg)
    stage_cfg.paths.experiment_dir = os.path.join(workdir, stage)
    return stage_cfg


def gated_submission(seg_exp: Experiment, emp_exp: Experiment,
                     threshold: float, out_path: str):
    """Gate the fold-mean segmentation test probabilities with the
    classifier's P(non-empty) and write the submission."""
    import pandas as pd
    seg_test = seg_exp.load_predictions("out_of_fold_test_predictions")
    emp_test = emp_exp.load_predictions("emptiness_oof_test_predictions")
    emp_by_id = {i: p[1] for i, p in zip(emp_test["ids"], emp_test["images"])}
    gate = np.array([emp_by_id.get(i, 1.0) for i in seg_test["ids"]])
    gated = emptiness.apply_emptiness_gating(
        np.asarray(seg_test["images"]), gate, threshold)
    y_pred = [(img[1] > threshold).astype(np.uint8) for img in gated]
    submission = create_submission(pd.DataFrame({"id": seg_test["ids"]}),
                                   y_pred)
    submission.to_csv(out_path, index=None, encoding="utf-8")
    logger.info("final gated submission -> %s", out_path)
    return submission


def oof_gated_scores(seg_exp: Experiment, emp_exp: Experiment,
                     train_b: DataBundle, threshold: float) -> Dict:
    """Ungated against gated (iou, iout) over the out-of-fold train
    predictions, where ground truth exists."""
    seg = seg_exp.load_predictions("out_of_fold_train_predictions")
    emp = emp_exp.load_predictions("emptiness_oof_train_predictions")
    emp_by_id = {i: p[1] for i, p in zip(emp["ids"], emp["images"])}
    id_to_mask = {i: m for i, m in zip(train_b.meta["id"].tolist(),
                                       train_b.masks)}
    ids = [i for i in seg["ids"] if i in id_to_mask]
    probs = np.asarray([p for i, p in zip(seg["ids"], seg["images"])
                        if i in id_to_mask])
    y_true = [id_to_mask[i] for i in ids]
    ungated_pred = [(p[1] > threshold).astype(np.uint8) for p in probs]
    gate = np.array([emp_by_id.get(i, 1.0) for i in ids])
    gated = emptiness.apply_emptiness_gating(probs, gate, threshold)
    gated_pred = [(p[1] > threshold).astype(np.uint8) for p in gated]
    u_iou, u_iout = api.calculate_scores(y_true, ungated_pred)
    g_iou, g_iout = api.calculate_scores(y_true, gated_pred)
    return {"ungated": {"iou": u_iou, "iout": u_iout},
            "gated": {"iou": g_iou, "iout": g_iout}}


def _stage_complete(exp: Experiment, scores_json: str,
                    outputs: tuple) -> bool:
    """A stage is done when its scores JSON and every prediction artifact
    the later stages read exist."""
    if not os.path.exists(os.path.join(exp.directory,
                                       f"{scores_json}.json")):
        return False
    return all(exp.has_output(name) for name in outputs)


def run_full_solution(cfg: Config, workdir: str, train_b: DataBundle,
                      test_b: DataBundle, use_stacking: bool = True,
                      device: Union[str, torch.device] = "cuda") -> Dict:
    """Every stage end to end under ``<workdir>/{segmentation,emptiness,
    stacking}``; returns each stage's scores and the final submission's
    path. With ``execution.resume`` a stage whose scores and downstream
    prediction artifacts persist is loaded instead of run again (the
    stacking stage also needs its submission, written after its
    scores)."""
    os.makedirs(workdir, exist_ok=True)
    resume = cfg.execution.resume

    # stage 1: segmentation CV ensemble (oof and fold-mean test preds)
    seg_cfg = _stage_config(cfg, workdir, "segmentation")
    seg_exp = Experiment(seg_cfg.paths.experiment_dir)
    seg_outputs = ("out_of_fold_train_predictions",) + (
        ("out_of_fold_test_predictions",) if test_b is not None else ())
    if resume and _stage_complete(seg_exp, "cv_scores", seg_outputs):
        seg_scores = seg_exp.load_json("cv_scores")
        logger.info("resume: segmentation stage already complete, "
                    "loaded cv_scores")
    else:
        seg_scores = api.train_evaluate_predict_cv(seg_cfg, seg_exp,
                                                   train_b, test_b, device)
    logger.info("segmentation CV: %s", seg_scores)

    # stage 2: emptiness classifier CV (oof gating probabilities)
    emp_cfg = _stage_config(cfg, workdir, "emptiness")
    emp_exp = Experiment(emp_cfg.paths.experiment_dir)
    emp_outputs = ("emptiness_oof_train_predictions",) + (
        ("emptiness_oof_test_predictions",) if test_b is not None else ())
    if resume and _stage_complete(emp_exp, "emptiness_cv_scores",
                                  emp_outputs):
        emp_scores = emp_exp.load_json("emptiness_cv_scores")
        logger.info("resume: emptiness stage already complete, "
                    "loaded emptiness_cv_scores")
    else:
        emp_scores = emptiness.train_evaluate_predict_cv(
            emp_cfg, emp_exp, train_b, test_b, device)
    logger.info("emptiness CV: %s", emp_scores)

    # stage 3: stacking second level over the segmentation oof preds
    stack_scores: Optional[Dict] = None
    if use_stacking:
        stack_cfg = _stage_config(cfg, workdir, "stacking")
        stack_exp = Experiment(stack_cfg.paths.experiment_dir)
        stack_submission_ok = (test_b is None or os.path.exists(
            os.path.join(stack_exp.directory, "stacking_submission.csv")))
        if (resume and stack_submission_ok
                and _stage_complete(stack_exp, "stacking_cv_scores", ())):
            stack_scores = stack_exp.load_json("stacking_cv_scores")
            logger.info("resume: stacking stage already complete, "
                        "loaded stacking_cv_scores")
        else:
            seg_dir = seg_cfg.paths.experiment_dir
            ids, cube = stacking.join_experiment_predictions([seg_dir],
                                                             "train")
            bundle_aligned, cube = stacking.stacking_bundle(train_b, ids,
                                                            cube)
            t_ids, t_cube = stacking.join_experiment_predictions([seg_dir],
                                                                 "test")
            test_aligned, t_cube = stacking.stacking_bundle(test_b, t_ids,
                                                            t_cube)
            stack_scores = stacking.train_evaluate_stacking(
                stack_cfg, stack_exp, bundle_aligned, cube, t_cube,
                test_aligned, device)
        logger.info("stacking CV: %s", stack_scores)

    # stage 4: gated final submission and the measured oof gating delta
    gating_scores = None
    if train_b.masks is not None:
        gating_scores = oof_gated_scores(seg_exp, emp_exp, train_b,
                                         cfg.postpro.threshold_masks)
        logger.info("oof gating delta: %s", gating_scores)
        _atomic_write_text(os.path.join(workdir, "gating_scores.json"),
                           json.dumps(gating_scores, indent=2,
                                      default=float))
    out_path = os.path.join(workdir, "final_submission.csv")
    gated_submission(seg_exp, emp_exp, cfg.postpro.threshold_masks, out_path)

    return {"segmentation": seg_scores, "emptiness": emp_scores,
            "stacking": stack_scores, "gating": gating_scores,
            "submission_path": out_path}
