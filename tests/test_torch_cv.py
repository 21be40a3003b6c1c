"""The port's evaluate / predict / CV entry points against the JAX
package's, on the CPU.

The same JAX-saved fold checkpoints and the same synthetic bundles go
through ``evaluate_predict_cv`` of both packages (UNetResNet18, fp32,
hflip TTA, 2 folds): the fold splits and ids are equal, the out-of-fold
probabilities agree within 2e-3 (the whole-model tolerance of
tests/test_torch_model.py), and the masks, the fold scores and
``submission.csv`` are compared under the threshold-margin rule of
tests/test_torch_serve.py: equal on every pixel whose margin from the
threshold exceeds the probability delta. The CLI then runs every new
command with ``--device cpu`` at a tiny size."""
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from torch_parity import flagship_config, numpy_jax_variables, port_config

from salt_tpu.core.experiment import Experiment as JaxExperiment
from salt_tpu.data.bundle import synthetic_bundle as jax_synthetic_bundle
from salt_tpu.models.registry import build_model as jax_build_model
from salt_tpu.ops.rle import run_length_decoding
from salt_tpu.pipeline import api as jax_api
from salt_tpu_torch import cli
from salt_tpu_torch.core.experiment import Experiment
from salt_tpu_torch.data.bundle import synthetic_bundle
from salt_tpu_torch.pipeline import api

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

N_TRAIN = 8
N_TEST = 6


def _cfg():
    cfg = flagship_config(18)
    cfg.training.batch_size_inference = 4
    cfg.execution.n_cv_splits = 2
    cfg.postpro.use_tta = True
    return cfg


@pytest.fixture(scope="module")
def cv_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cv")
    cfg = _cfg()
    seeded = JaxExperiment(str(root / "seeded"))
    jax_model = jax_build_model(cfg.model, "float32")
    for fold, seed in enumerate((10, 11)):
        variables, _ = numpy_jax_variables(jax_model, seed=seed)
        seeded.save_params(f"network_fold_{fold}", variables)
    seeded.flush_saves()
    for name in ("jax", "port"):
        shutil.copytree(seeded.directory, root / name)

    jax_scores = jax_api.evaluate_predict_cv(
        cfg, JaxExperiment(str(root / "jax")),
        jax_synthetic_bundle(N_TRAIN, seed=3),
        jax_synthetic_bundle(N_TEST, seed=4, with_masks=False))
    pcfg = port_config(cfg)
    port_scores = api.evaluate_predict_cv(
        pcfg, Experiment(str(root / "port")), synthetic_bundle(N_TRAIN, seed=3),
        synthetic_bundle(N_TEST, seed=4, with_masks=False), device="cpu")
    return dict(root=root, jax=jax_scores, port=port_scores)


def _outputs(directory, name):
    with np.load(os.path.join(directory, "outputs", f"{name}.npz"),
                 allow_pickle=True) as z:
        return list(z["ids"]), z["images"]


def _masks(csv_path):
    sub = pd.read_csv(csv_path, keep_default_na=False)
    return sub["id"].tolist(), np.stack(
        [run_length_decoding(r, (101, 101)) for r in sub["rle_mask"]])


def _margin_rule(p_port, p_jax, masks_port, masks_jax, threshold=0.5):
    """Masks equal wherever the JAX probability clears the threshold by
    more than the probability delta; returns the undecidable count."""
    delta = float(np.abs(p_port - p_jax).max())
    assert delta < 2e-3, f"probability delta vs JAX: {delta}"
    decidable = np.abs(p_jax - threshold) > delta
    np.testing.assert_array_equal(masks_port[decidable], masks_jax[decidable])
    return int((~decidable).sum())


def test_out_of_fold_predictions_match_jax(cv_runs):
    root = cv_runs["root"]
    for name in ("out_of_fold_train_predictions",
                 "out_of_fold_test_predictions"):
        ids_j, p_j = _outputs(root / "jax", name)
        ids_p, p_p = _outputs(root / "port", name)
        assert ids_p == ids_j
        assert p_p.shape == p_j.shape and p_p.dtype == np.float32
        np.testing.assert_allclose(p_p, p_j, rtol=2e-3, atol=2e-3)


def test_fold_scores_match_jax_under_margin_rule(cv_runs):
    """Fold masks equal under the margin rule; where no pixel of the
    out-of-fold predictions is undecidable the fold scores are equal."""
    root = cv_runs["root"]
    _, p_j = _outputs(root / "jax", "out_of_fold_train_predictions")
    _, p_p = _outputs(root / "port", "out_of_fold_train_predictions")
    undecidable = _margin_rule(p_p[:, 1], p_j[:, 1], p_p[:, 1] > 0.5,
                               p_j[:, 1] > 0.5)
    assert undecidable <= 5
    port, jax_ = cv_runs["port"], cv_runs["jax"]
    assert len(port["fold_iout"]) == len(jax_["fold_iout"]) == 2
    if undecidable == 0:
        for key in ("fold_iou", "fold_iout"):
            np.testing.assert_allclose(port[key], jax_[key], rtol=0,
                                       atol=1e-6)
    with open(root / "port" / "cv_scores.json") as f:
        assert json.load(f) == port


def test_submission_matches_jax_under_margin_rule(cv_runs):
    root = cv_runs["root"]
    ids_j, masks_j = _masks(root / "jax" / "submission.csv")
    ids_p, masks_p = _masks(root / "port" / "submission.csv")
    assert ids_p == ids_j and len(ids_p) == N_TEST
    _, p_j = _outputs(root / "jax", "out_of_fold_test_predictions")
    _, p_p = _outputs(root / "port", "out_of_fold_test_predictions")
    assert _margin_rule(p_p[:, 1], p_j[:, 1], masks_p, masks_j) <= 5
    np.testing.assert_array_equal(masks_p, p_p[:, 1] > 0.5)


def _files(directory):
    """Artifact paths under ``directory`` (hidden bookkeeping files, such
    as the JAX package's writer note, aside)."""
    return {os.path.relpath(os.path.join(d, f), directory)
            for d, _, files in os.walk(directory) for f in files
            if not f.startswith(".")}


def test_cli_commands_run_on_the_cpu(cv_runs, tmp_path):
    """train-evaluate-predict-cv writes every artifact the JAX package's
    evaluate_predict_cv writes, plus what its fits write (config, channel
    logs, best and last checkpoints); then evaluate-cv,
    evaluate-predict-cv, train-evaluate-cv, train, evaluate and predict
    run (``evaluate-cv`` scoring the same folds as the training run)."""
    exp = tmp_path / "exp"
    flags = ["--synthetic", "8", "--epochs", "1", "--device", "cpu",
             "--set", f"paths.experiment_dir={exp}",
             "--set", "model.encoder_depth=18",
             "--set", "training.dtype=float32",
             "--set", "training.batch_size_train=4",
             "--set", "training.batch_size_inference=4",
             "--set", "execution.n_cv_splits=2"]
    assert cli.main(["train-evaluate-predict-cv", *flags]) == 0
    files = _files(exp)
    jax_files = _files(cv_runs["root"] / "jax")
    assert jax_files - files == set(), jax_files - files
    for fold in range(2):
        for f in (f"channels_network_fold_{fold}.jsonl",
                  f"checkpoints/network_fold_{fold}/best.npz",
                  f"checkpoints/network_fold_{fold}/last.npz"):
            assert f in files, f
    assert "config.json" in files
    _, masks = _masks(exp / "submission.csv")
    assert masks.shape == (max(8 // 4, 8), 101, 101)
    with open(exp / "cv_scores.json") as f:
        trained = json.load(f)

    for command in ("evaluate-cv", "evaluate-predict-cv"):
        assert cli.main([command, *flags]) == 0
        with open(exp / "cv_scores.json") as f:
            assert json.load(f) == trained
    exp2 = tmp_path / "exp2"
    flags2 = [f"paths.experiment_dir={exp2}" if f.startswith("paths.")
              else f for f in flags]
    assert cli.main(["train-evaluate-cv", *flags2]) == 0
    assert "outputs/out_of_fold_train_predictions.npz" in _files(exp2)
    for command in ("train", "evaluate", "predict"):
        assert cli.main([command, *flags2]) == 0
    files2 = _files(exp2)
    assert {"validation_results.json", "submission.csv",
            "outputs/validation_predictions.npz",
            "checkpoints/network/best.npz"} <= files2
