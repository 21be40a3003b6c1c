"""The port's emptiness pipeline against the JAX package's on the CPU.

- ``apply_emptiness_gating`` and ``resize_emptiness_predictions`` equal
  JAX's.
- Fold checkpoints written by the JAX package (seeded ResNet-18
  classifiers, 2 folds) through ``evaluate_predict_cv`` of both packages
  on the same 24 synthetic images: the same ids; out-of-fold and test
  probabilities within 2e-3 (the whole-model tolerance); the AUC of
  JAX's probabilities is the same number under both ``roc_auc``s, and
  the port's fold AUCs equal JAX's where no pair of the port's scores
  swaps order against JAX's.
- ``empty-cv`` of the port's CLI (``--device cpu``, 24 images, 1 epoch)
  writes every artifact JAX's writes, with JAX's keys and shapes, and
  its fold checkpoints load in the JAX package, whose
  ``evaluate_cv`` gives the port's probabilities within 2e-3.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from torch_parity import numpy_jax_variables, port_config

from salt_tpu.core.config import default_config
from salt_tpu.core.experiment import Experiment as JaxExperiment
from salt_tpu.data.bundle import synthetic_bundle as jax_synthetic_bundle
from salt_tpu.metrics.auc import roc_auc as jax_roc_auc
from salt_tpu.models.emptiness import EmptinessClassifier as JaxClassifier
from salt_tpu.pipeline import emptiness as jax_emptiness
from salt_tpu_torch import cli
from salt_tpu_torch.core.experiment import Experiment
from salt_tpu_torch.data.bundle import synthetic_bundle
from salt_tpu_torch.metrics.auc import roc_auc
from salt_tpu_torch.pipeline import emptiness

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

N_TRAIN = 24
N_TEST = 6


def _cfg():
    cfg = default_config()
    cfg.training.dtype = "float32"
    cfg.training.batch_size_train = 8
    cfg.training.batch_size_inference = 8
    cfg.execution.n_cv_splits = 2
    return cfg


def _outputs(directory, name):
    with np.load(os.path.join(directory, "outputs", f"{name}.npz"),
                 allow_pickle=True) as z:
        return list(z["ids"]), z["images"]


def _files(directory):
    return {os.path.relpath(os.path.join(d, f), directory)
            for d, _, files in os.walk(directory) for f in files
            if not f.startswith(".")}


def test_gating_and_resize_equal_jax():
    rng = np.random.RandomState(0)
    seg = rng.rand(6, 2, 101, 101).astype(np.float32)
    p = np.array([0.9, 0.1, 0.5, 0.4999, 0.0, 1.0], np.float32)
    for thr in (0.5, 0.3):
        np.testing.assert_array_equal(
            emptiness.apply_emptiness_gating(seg, p, thr),
            jax_emptiness.apply_emptiness_gating(seg, p, thr))
    probs = rng.rand(6, 2).astype(np.float32)
    got = emptiness.resize_emptiness_predictions(probs)
    np.testing.assert_array_equal(
        got, jax_emptiness.resize_emptiness_predictions(probs))
    assert got.shape == (6, 2, 101, 101) and got.dtype == np.float32


@pytest.fixture(scope="module")
def jax_folds(tmp_path_factory):
    """JAX-written fold checkpoints through both packages'
    ``evaluate_predict_cv``."""
    root = tmp_path_factory.mktemp("emptiness")
    cfg = _cfg()
    seeded = JaxExperiment(str(root / "seeded"))
    model = JaxClassifier(encoder_depth=18)
    for fold, seed in enumerate((20, 21)):
        variables, _ = numpy_jax_variables(model, seed=seed)
        seeded.save_params(f"emptiness_fold_{fold}", variables)
    seeded.flush_saves()
    for name in ("jax", "port"):
        shutil.copytree(seeded.directory, root / name)
    jax_scores = jax_emptiness.evaluate_predict_cv(
        cfg, JaxExperiment(str(root / "jax")),
        jax_synthetic_bundle(N_TRAIN, seed=3),
        jax_synthetic_bundle(N_TEST, seed=4, with_masks=False))
    port_scores = emptiness.evaluate_predict_cv(
        port_config(cfg), Experiment(str(root / "port")),
        synthetic_bundle(N_TRAIN, seed=3),
        synthetic_bundle(N_TEST, seed=4, with_masks=False), device="cpu")
    return dict(root=root, jax=jax_scores, port=port_scores)


def test_jax_fold_checkpoints_give_jax_probabilities(jax_folds):
    root = jax_folds["root"]
    for name, shape in (("emptiness_oof_train_predictions", (N_TRAIN, 2)),
                        ("emptiness_oof_test_predictions", (N_TEST, 2))):
        ids_j, p_j = _outputs(root / "jax", name)
        ids_p, p_p = _outputs(root / "port", name)
        assert ids_p == ids_j
        assert p_p.shape == p_j.shape == shape
        assert p_p.dtype == p_j.dtype == np.float32
        np.testing.assert_allclose(p_p, p_j, rtol=2e-3, atol=2e-3)


def test_fold_aucs_match_jax(jax_folds):
    root = jax_folds["root"]
    _, p_j = _outputs(root / "jax", "emptiness_oof_train_predictions")
    _, p_p = _outputs(root / "port", "emptiness_oof_train_predictions")
    labels = jax_synthetic_bundle(N_TRAIN, seed=3).meta["is_not_empty"].values
    ids = _outputs(root / "jax", "emptiness_oof_train_predictions")[0]
    order = {i: k for k, i in enumerate(
        jax_synthetic_bundle(N_TRAIN, seed=3).meta["id"])}
    y = labels[[order[i] for i in ids]]
    n = N_TRAIN // 2
    for fold in range(2):
        part = slice(fold * n, (fold + 1) * n)
        want = jax_folds["jax"]["fold_auc"][fold]
        assert roc_auc(y[part], p_j[part, 1]) == want
        assert jax_roc_auc(y[part], p_j[part, 1]) == want
        # the port's AUC is JAX's unless two scores swap order
        a, b = p_p[part, 1], p_j[part, 1]
        swaps = np.sign(a[:, None] - a[None]) != np.sign(b[:, None] - b[None])
        if not swaps.any():
            assert jax_folds["port"]["fold_auc"][fold] == want
    with open(root / "port" / "emptiness_cv_scores.json") as f:
        scores = json.load(f)
    assert scores == jax_folds["port"]
    assert set(scores) == set(jax_folds["jax"]) == {"auc_mean", "auc_std",
                                                    "fold_auc"}


def test_empty_cv_writes_jax_artifacts_and_jax_reads_its_folds(
        jax_folds, tmp_path):
    exp = tmp_path / "empty"
    flags = ["--synthetic", str(N_TRAIN), "--epochs", "1", "--device", "cpu",
             "--set", f"paths.experiment_dir={exp}",
             "--set", "training.dtype=float32",
             "--set", "training.batch_size_train=8",
             "--set", "training.batch_size_inference=8",
             "--set", "execution.n_cv_splits=2"]
    assert cli.main(["empty-cv", *flags]) == 0
    files = _files(exp)
    jax_files = _files(jax_folds["root"] / "jax")
    assert jax_files - files == set(), jax_files - files
    for fold in range(2):
        for f in (f"channels_emptiness_fold_{fold}.jsonl",
                  f"checkpoints/emptiness_fold_{fold}/best.npz",
                  f"checkpoints/emptiness_fold_{fold}/last.npz"):
            assert f in files, f
    with open(exp / "config.json") as f:
        assert json.load(f)["model"]["architecture"] == "EmptinessClassifier"
    _, p_train = _outputs(exp, "emptiness_oof_train_predictions")
    ids_test, p_test = _outputs(exp, "emptiness_oof_test_predictions")
    assert p_train.shape == (N_TRAIN, 2)
    assert p_test.shape == (max(N_TRAIN // 4, 8), 2)

    # the JAX package evaluates the port's fold checkpoints
    jexp = tmp_path / "jax_reads"
    shutil.copytree(exp, jexp)
    cfg = _cfg()
    scores = jax_emptiness.evaluate_cv(
        cfg, JaxExperiment(str(jexp)),
        jax_synthetic_bundle(N_TRAIN, seed=cfg.execution.seed))
    assert len(scores["fold_auc"]) == 2
    _, p_jax = _outputs(jexp, "emptiness_oof_train_predictions")
    np.testing.assert_allclose(p_jax, p_train, rtol=2e-3, atol=2e-3)

    # the eval-only commands rescore the same folds
    for command in ("empty-evaluate-cv", "empty-evaluate-predict-cv"):
        assert cli.main([command, *flags]) == 0
        _, p = _outputs(exp, "emptiness_oof_train_predictions")
        np.testing.assert_allclose(p, p_train, rtol=0, atol=1e-6)

    # the first-fold commands
    flags1 = [f"paths.experiment_dir={tmp_path / 'one'}"
              if f.startswith("paths.") else f for f in flags]
    assert cli.main(["empty-train", *flags1]) == 0
    assert cli.main(["empty-evaluate", *flags1]) == 0
    with open(tmp_path / "one" / "emptiness_validation_results.json") as f:
        assert 0.0 <= json.load(f)["auc"] <= 1.0
    assert (tmp_path / "one" / "checkpoints" / "emptiness" / "best.npz"
            ).exists()
