"""The port's ``full-solution`` (tests/test_full_solution.py's seven
cases on the port, the same SaltUNet-8 config at ``--device cpu``), and
the JAX package's ``gated_submission`` / ``oof_gated_scores`` run on the
port's stage directories: the same CSV and scores as the port's."""
import glob
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from salt_tpu.core.experiment import Experiment as JaxExperiment
from salt_tpu.data.bundle import synthetic_bundle as jax_synthetic_bundle
from salt_tpu.pipeline import full_solution as jax_full_solution
from salt_tpu_torch.core.config import default_config
from salt_tpu_torch.core.experiment import Experiment
from salt_tpu_torch.data.bundle import synthetic_bundle

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

SETS = ["model.architecture=SaltUNet", "model.n_filters=8",
        "model.repeat_blocks=2", "training.batch_size_train=8",
        "training.batch_size_inference=8", "training.dtype=float32",
        "execution.n_cv_splits=2"]


@pytest.fixture(scope="module")
def solution_dirs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("full_solution"))
    from salt_tpu_torch import cli
    args = ["full-solution", "--synthetic", "32", "--epochs", "1",
            "--workdir", workdir, "--device", "cpu",
            "--set", f"paths.experiment_dir={workdir}/unused"]
    for item in SETS:
        args += ["--set", item]
    assert cli.main(args) == 0
    return workdir


def _resume_config(w):
    cfg = default_config()
    cfg.model.architecture = "SaltUNet"
    cfg.model.n_filters = 8
    cfg.model.repeat_blocks = 2
    cfg.training.epochs = 1
    cfg.training.batch_size_train = 8
    cfg.training.batch_size_inference = 8
    cfg.training.dtype = "float32"
    cfg.execution.n_cv_splits = 2
    cfg.execution.resume = True
    cfg.paths.experiment_dir = f"{w}/unused"
    return cfg


def _bundles(cfg):
    return (synthetic_bundle(32, seed=cfg.execution.seed),
            synthetic_bundle(8, seed=cfg.execution.seed + 1,
                             with_masks=False))


def test_all_stages_persist(solution_dirs):
    w = solution_dirs
    assert os.path.exists(f"{w}/segmentation/cv_scores.json")
    assert os.path.exists(f"{w}/emptiness/emptiness_cv_scores.json")
    assert os.path.exists(f"{w}/stacking/stacking_cv_scores.json")
    assert os.path.exists(f"{w}/final_submission.csv")
    with open(f"{w}/gating_scores.json") as f:
        assert set(json.load(f)) == {"ungated", "gated"}


def test_final_submission_contract(solution_dirs):
    sub = pd.read_csv(f"{solution_dirs}/final_submission.csv")
    assert list(sub.columns) == ["id", "rle_mask"]
    assert len(sub) == 8   # synthetic test split: max(32 // 4, 8)


def test_gating_zeroes_predicted_empty(solution_dirs):
    w = solution_dirs
    emp = Experiment(f"{w}/emptiness").load_predictions(
        "emptiness_oof_test_predictions")
    sub = pd.read_csv(f"{w}/final_submission.csv").set_index("id")
    for image_id, p in zip(emp["ids"], emp["images"]):
        if p[1] < 0.5:
            rle = sub.loc[image_id, "rle_mask"]
            assert pd.isna(rle) or rle == ""


def test_emptiness_evaluate_predict_cv(solution_dirs):
    """Eval-only CV over the persisted fold classifiers reproduces the
    trained run's AUCs without retraining."""
    from salt_tpu_torch.pipeline import emptiness
    cfg = _resume_config(solution_dirs)
    cfg.execution.resume = False
    exp = Experiment(f"{solution_dirs}/emptiness")
    with open(f"{solution_dirs}/emptiness/emptiness_cv_scores.json") as f:
        trained = json.load(f)
    scores = emptiness.evaluate_predict_cv(cfg, exp, *_bundles(cfg),
                                           device="cpu")
    assert np.allclose(scores["fold_auc"], trained["fold_auc"], atol=1e-6)
    assert len(exp.load_predictions("emptiness_oof_test_predictions")["ids"]) == 8


def test_jax_gating_on_the_port_stage_dirs(solution_dirs, tmp_path):
    """The JAX package's gated submission and out-of-fold gating scores,
    computed from the port's persisted predictions, are the port's."""
    w = solution_dirs
    seg = JaxExperiment(f"{w}/segmentation")
    emp = JaxExperiment(f"{w}/emptiness")
    out = str(tmp_path / "jax_final.csv")
    jax_full_solution.gated_submission(seg, emp, 0.5, out)
    with open(out) as a, open(f"{w}/final_submission.csv") as b:
        assert a.read() == b.read()
    scores = jax_full_solution.oof_gated_scores(
        seg, emp, jax_synthetic_bundle(32, seed=default_config().execution.seed),
        0.5)
    with open(f"{w}/gating_scores.json") as f:
        port = json.load(f)
    for kind in ("ungated", "gated"):
        for metric in ("iou", "iout"):
            assert abs(scores[kind][metric] - port[kind][metric]) <= 1e-6


def test_resume_skips_completed_stages(solution_dirs):
    from salt_tpu_torch.pipeline.full_solution import run_full_solution
    w = solution_dirs
    ckpts = sorted(glob.glob(f"{w}/*/checkpoints/**/*.npz", recursive=True))
    assert len(ckpts) == 12     # 3 stages x 2 folds x best, last
    before = {p: os.path.getmtime(p) for p in ckpts}
    with open(f"{w}/final_submission.csv") as f:
        submission = f.read()
    cfg = _resume_config(w)
    results = run_full_solution(cfg, w, *_bundles(cfg), device="cpu")
    with open(f"{w}/segmentation/cv_scores.json") as f:
        assert results["segmentation"] == json.load(f)
    assert results["stacking"] is not None
    for p, t in before.items():
        assert os.path.getmtime(p) == t, f"stage retrained: {p}"
    with open(results["submission_path"]) as f:
        assert f.read() == submission


def test_resume_reruns_stacking_if_submission_missing(solution_dirs):
    from salt_tpu_torch.pipeline.full_solution import run_full_solution
    w = solution_dirs
    sub = f"{w}/stacking/stacking_submission.csv"
    assert os.path.exists(sub)
    os.remove(sub)
    cfg = _resume_config(w)
    cfg.execution.resume = True
    results = run_full_solution(cfg, w, *_bundles(cfg), device="cpu")
    assert results["stacking"] is not None
    assert os.path.exists(sub)


def test_oof_gating_delta_is_measured(solution_dirs):
    from salt_tpu_torch.pipeline.full_solution import oof_gated_scores
    w = solution_dirs
    scores = oof_gated_scores(Experiment(f"{w}/segmentation"),
                              Experiment(f"{w}/emptiness"),
                              _bundles(default_config())[0], 0.5)
    for kind in ("ungated", "gated"):
        assert 0.0 <= scores[kind]["iou"] <= 1.0
        assert 0.0 <= scores[kind]["iout"] <= 1.0
