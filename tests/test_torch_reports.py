"""The port's report commands against the JAX package's on the same
inputs: ``data-stats`` (and its stacking report), ``verify-data`` and
``analyze`` give the same dicts and text; ``augment-preview`` with the
draws JAX makes from its keys gives the same PNG within one grey level.
Each command then runs from the CLI (``augment-preview`` with
``--device cpu``; the other three touch no device)."""
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from torch_parity import port_config
from torch_train_parity import jax_augment_params

from salt_tpu.core.config import default_config
from salt_tpu.core.experiment import Experiment as JaxExperiment
from salt_tpu.data import stats as jax_stats
from salt_tpu.data import verify as jax_verify
from salt_tpu.data.bundle import synthetic_bundle as jax_synthetic_bundle
from salt_tpu.data.metadata import generate_metadata
from salt_tpu.data.synthetic import write_synthetic_dataset
from salt_tpu.pipeline import analysis as jax_analysis
from salt_tpu.pipeline.preview import \
    render_preview_grid as jax_render_preview_grid
from salt_tpu_torch import cli
from salt_tpu_torch.core.experiment import Experiment
from salt_tpu_torch.data import stats, verify
from salt_tpu_torch.data.bundle import load_bundle, synthetic_bundle
from salt_tpu_torch.models.convert import to_flax_flat
from salt_tpu_torch.models.registry import build_model, init_seeded
from salt_tpu_torch.pipeline import analysis
from salt_tpu_torch.pipeline.preview import render_preview_grid

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

SEED = default_config().execution.seed


def _oof(root, ids, seed=0, n_exp=2):
    rng = np.random.RandomState(seed)
    dirs = []
    for e in range(n_exp):
        d = str(root / f"oof{e}")
        field = rng.rand(len(ids), 2, 13, 13)
        probs = np.repeat(np.repeat(field, 8, axis=2), 8, axis=3)
        JaxExperiment(d).save_predictions(
            "out_of_fold_train_predictions", ids,
            probs[..., :101, :101].astype(np.float32))
        dirs.append(d)
    return dirs


def test_data_stats_equal_jax(tmp_path, capsys):
    train_j = jax_synthetic_bundle(24, seed=SEED, difficulty="hard")
    test_j = jax_synthetic_bundle(8, seed=SEED + 1, with_masks=False,
                                  difficulty="hard")
    train_p = synthetic_bundle(24, seed=SEED, difficulty="hard")
    test_p = synthetic_bundle(8, seed=SEED + 1, with_masks=False,
                              difficulty="hard")
    want = jax_stats.bundle_stats(train_j, test_j)
    got = stats.bundle_stats(train_p, test_p)
    assert got == want and "depth_salt_correlation" in got
    assert stats.format_stats(got) == jax_stats.format_stats(want)

    ids = train_j.meta["id"].tolist()
    dirs = _oof(tmp_path, ids)
    from salt_tpu.pipeline.stacking import join_experiment_predictions
    j_ids, cube = join_experiment_predictions(dirs, "train")
    want = jax_stats.stacking_stats(j_ids, cube, train_j, 0.5)
    got = stats.stacking_stats(j_ids, cube, train_p, 0.5)
    assert got == want and "per_model_pixel_accuracy" in got
    text = stats.format_stacking_stats(got)
    assert text == jax_stats.format_stacking_stats(want)

    assert cli.main(["data-stats", "--synthetic", "24",
                     "--synthetic-difficulty", "hard",
                     "--stacking-experiments", *dirs]) == 0
    out = capsys.readouterr().out
    assert stats.format_stats(stats.bundle_stats(
        train_p, synthetic_bundle(max(24 // 4, 8), seed=SEED + 1,
                                  with_masks=False, difficulty="hard"))) in out
    assert text in out


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("verify"))
    train_dir, test_dir, depths = write_synthetic_dataset(root, n_train=8,
                                                          n_test=4, seed=2)
    meta = generate_metadata(train_dir, test_dir, depths)
    path = os.path.join(root, "metadata.csv")
    meta.to_csv(path, index=None)
    return root, path


def _verify_config(root, path, n_filters=8):
    cfg = default_config()
    cfg.model.architecture = "SaltUNet"
    cfg.model.n_filters = n_filters
    cfg.paths.metadata_filepath = path
    cfg.paths.experiment_dir = os.path.join(root, "exp")
    cfg.execution.pack_cache_dir = os.path.join(root, "packs")
    return cfg


def test_verify_data_equals_jax(dataset, capsys):
    root, path = dataset
    cfg = _verify_config(root, path)
    pcfg = port_config(cfg)
    meta = pd.read_csv(path)
    # a pack the port cached, a checkpoint the port wrote
    load_bundle(meta[meta["is_train"] == 1],
                cache_dir=pcfg.execution.pack_cache_dir)
    model = init_seeded(build_model(pcfg.model), 0)
    Experiment(pcfg.paths.experiment_dir).save_params("network_fold_0",
                                                      to_flax_flat(model))
    want = jax_verify.verify_data(cfg)
    got = verify.verify_data(pcfg)
    assert got == want
    assert all(r["ok"] for r in got.values()), got
    assert got["pack_cache"]["detail"].startswith("cached pack ok")
    # a config the checkpoint does not fit
    cfg16 = _verify_config(root, path, n_filters=16)
    want = jax_verify.verify_checkpoints(cfg16, cfg16.paths.experiment_dir)
    got = verify.verify_checkpoints(port_config(cfg16),
                                    cfg16.paths.experiment_dir)
    assert got == want and not got["ok"]
    exp = pcfg.paths.experiment_dir
    assert cli.main(["verify-data", "--set", f"paths.metadata_filepath={path}",
                     "--set", f"paths.experiment_dir={exp}",
                     "--set", "model.architecture=SaltUNet",
                     "--set", "model.n_filters=8"]) == 0
    assert "[ok] checkpoint: 1 checkpoint(s) match SaltUNet" in \
        capsys.readouterr().out
    missing = meta.copy()
    missing.loc[0, "file_path_image"] = "/nonexistent.png"
    assert verify.verify_metadata(missing) == jax_verify.verify_metadata(
        missing)


def test_analyze_equals_jax(tmp_path, capsys):
    bundle_j = jax_synthetic_bundle(20, seed=SEED)
    ids = bundle_j.meta["id"].tolist()[::-1]
    d = _oof(tmp_path, ids, seed=4, n_exp=1)[0]
    want = jax_analysis.analyze_experiment(JaxExperiment(d), bundle_j, 0.5)
    got = analysis.analyze_experiment(Experiment(d),
                                      synthetic_bundle(20, seed=SEED), 0.5)
    assert got == want
    assert analysis.format_report(got) == jax_analysis.format_report(want)
    assert cli.main(["analyze", "--synthetic", "20",
                     "--set", f"paths.experiment_dir={d}"]) == 0
    assert analysis.format_report(got) in capsys.readouterr().out


def test_augment_preview_with_jax_draws_equals_jax(tmp_path):
    b = jax_synthetic_bundle(3, seed=5)
    seed = 7
    want = jax_render_preview_grid(b.images, b.masks, n_samples=3, seed=seed)
    base = jax.random.PRNGKey(seed)
    got = render_preview_grid(
        b.images, b.masks, n_samples=3, seed=seed, device="cpu",
        draw=lambda s: jax_augment_params(jax.random.fold_in(base, s), 3,
                                          101, 101))
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()

    out = tmp_path / "preview.png"
    assert cli.main(["augment-preview", "--synthetic", "8", "--device", "cpu",
                     "--preview-images", "2", "--preview-samples", "2",
                     "--out", str(out)]) == 0
    from PIL import Image
    assert np.asarray(Image.open(out)).shape == (2 * 202 + 3, 3 * 101 + 6)
    exp = tmp_path / "exp"
    assert cli.main(["augment-preview", "--synthetic", "8", "--device", "cpu",
                     "--preview-images", "1", "--preview-samples", "1",
                     "--set", f"paths.experiment_dir={exp}"]) == 0
    assert (exp / "augment_preview.png").exists()
