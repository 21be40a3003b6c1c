"""The depth model through every command on the CPU: with
``model.architecture=UNetResNetWithDepth`` (depth 18, fp32, batch 4) and
``execution.use_depth=true``, ``--device cpu``: ``train --synthetic 16``
for 1 epoch, then ``evaluate``, ``predict``, ``serve --synthetic 4`` from the
experiment directory, and ``train-evaluate-predict-cv`` /
``evaluate-predict-cv`` over 2 folds. ``serve`` feeds every image depth
0, as the JAX package's serve does: its masks are the runner's TTA
prediction with zero depths, bit for bit, and not the one with the
bundle's depths."""
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from salt_tpu.ops.rle import run_length_decoding
from salt_tpu_torch import cli
from salt_tpu_torch.core.config import load_config
from salt_tpu_torch.data.bundle import synthetic_bundle
from salt_tpu_torch.pipeline.serving import (adopt_checkpoint_config,
                                            resolve_checkpoints)
from salt_tpu_torch.train.steps import SegmentationRunner

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

SETTINGS = {"model.architecture": "UNetResNetWithDepth",
            "model.encoder_depth": 18, "execution.use_depth": True,
            "training.dtype": "float32", "training.batch_size_train": 4,
            "training.batch_size_inference": 4, "execution.n_cv_splits": 2}


def _flags(exp, n):
    flags = ["--synthetic", str(n), "--epochs", "1", "--device", "cpu",
             "--set", f"paths.experiment_dir={exp}"]
    for k, v in SETTINGS.items():
        flags += ["--set", f"{k}={str(v).lower() if v is True else v}"]
    return flags


def _masks(csv_path):
    sub = pd.read_csv(csv_path, keep_default_na=False)
    return sub["id"].tolist(), np.stack(
        [run_length_decoding(r, (101, 101)) for r in sub["rle_mask"]])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    exp = tmp_path_factory.mktemp("depth_cli") / "exp"
    assert cli.main(["train", *_flags(exp, 16)]) == 0
    return exp


def test_train_evaluate_predict(trained):
    flags = _flags(trained, 16)
    with open(trained / "config.json") as f:
        saved = json.load(f)
    assert saved["model"]["architecture"] == "UNetResNetWithDepth"
    assert saved["execution"]["use_depth"] is True
    assert cli.main(["evaluate", *flags]) == 0
    assert cli.main(["predict", *flags]) == 0
    with open(trained / "validation_results.json") as f:
        scores = json.load(f)
    assert 0.0 <= scores["iout"] <= 1.0
    ids, masks = _masks(trained / "submission.csv")
    assert masks.shape == (8, 101, 101) and len(set(ids)) == 8


def test_serve_feeds_zero_depths(trained, tmp_path):
    out = tmp_path / "serve.csv"
    assert cli.main(["serve", "--checkpoint", str(trained), "--synthetic",
                     "4", "--out", str(out), "--device", "cpu"]) == 0
    ids, masks = _masks(out)

    cfg = adopt_checkpoint_config(load_config(None, {}), str(trained))
    assert cfg.model.architecture == "UNetResNetWithDepth"
    runner = SegmentationRunner(cfg, device="cpu")
    model = runner.restore(resolve_checkpoints(str(trained))[0])
    bundle = synthetic_bundle(4, seed=cfg.execution.seed, with_masks=False)
    assert ids == bundle.meta["id"].tolist()
    zeros = runner.predict_dataset(model, bundle.images,
                                   np.zeros(4, np.float32), tta=True)
    np.testing.assert_array_equal(masks, zeros[:, 1] > 0.5)
    with_depths = runner.predict_dataset(model, bundle.images,
                                         bundle.depths, tta=True)
    assert np.abs(with_depths - zeros).max() > 0


def test_cv_commands(tmp_path):
    exp = tmp_path / "cv"
    flags = _flags(exp, 8)
    assert cli.main(["train-evaluate-predict-cv", *flags]) == 0
    with open(exp / "cv_scores.json") as f:
        trained = json.load(f)
    assert len(trained["fold_iout"]) == 2
    assert cli.main(["evaluate-predict-cv", *flags]) == 0
    with open(exp / "cv_scores.json") as f:
        assert json.load(f) == trained
    for fold in range(2):
        assert os.path.exists(
            exp / "checkpoints" / f"network_fold_{fold}" / "best.npz")
