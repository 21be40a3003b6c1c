"""LargeKernelMatters and PSPNet through the port's command line on the
CPU, as a user runs them: ``train`` for an epoch and ``serve
--synthetic`` from the trained experiment (its config.json names the
architecture), and the CV commands. ResNet-18 encoders, fp32, 8
synthetic images (2 folds of 4 / 4), batch 4. A path check: finite losses, every artifact
written, ids and masks in the submissions."""
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from salt_tpu_torch import cli

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


def _flags(exp, arch):
    return ["--synthetic", "8", "--epochs", "1", "--device", "cpu",
            "--set", f"paths.experiment_dir={exp}",
            "--set", f"model.architecture={arch}",
            "--set", "model.encoder_depth=18",
            "--set", "training.dtype=float32",
            "--set", "training.batch_size_train=4",
            "--set", "training.batch_size_inference=4",
            "--set", "execution.n_cv_splits=2"]


@pytest.mark.parametrize("arch", ["PSPNet", "LargeKernelMatters"])
def test_train_then_serve(arch, tmp_path):
    exp = str(tmp_path / "exp")
    assert cli.main(["train", *_flags(exp, arch)]) == 0
    with open(os.path.join(exp, "config.json")) as f:
        assert json.load(f)["model"]["architecture"] == arch
    with open(os.path.join(exp, "channels_network.jsonl")) as f:
        epochs = [json.loads(line) for line in f]
    assert len(epochs) == 1 and np.isfinite(epochs[0]["train_loss"])
    out = str(tmp_path / "sub.csv")
    assert cli.main(["serve", "--checkpoint", exp, "--synthetic", "4",
                     "--out", out, "--device", "cpu"]) == 0
    sub = pd.read_csv(out)
    assert len(sub) == 4 and list(sub.columns) == ["id", "rle_mask"]


def test_cv_commands_run_lkm(tmp_path):
    exp = str(tmp_path / "cv")
    flags = _flags(exp, "LargeKernelMatters")
    assert cli.main(["train-evaluate-predict-cv", *flags]) == 0
    with open(os.path.join(exp, "cv_scores.json")) as f:
        scores = json.load(f)
    assert len(scores["fold_iout"]) == 2
    assert cli.main(["evaluate-predict-cv", *flags]) == 0
    assert len(pd.read_csv(os.path.join(exp, "submission.csv"))) == 8
