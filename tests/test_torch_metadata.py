"""The port's metadata generation (``salt_tpu_torch/data/metadata.py``) and
its ``prepare-metadata`` command against the JAX package's, on a tiny
TGS-layout tree (``train/{images,masks}``, ``test/images``, depths.csv)
that the JAX package's ``write_synthetic_dataset`` writes."""
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from salt_tpu import cli as jax_cli
from salt_tpu.core.config import default_config as jax_default_config
from salt_tpu.data import bundle as jax_bundle
from salt_tpu.data import metadata as jax_metadata
from salt_tpu.data.synthetic import write_synthetic_dataset
from salt_tpu_torch import cli
from salt_tpu_torch.core import device as port_device
from salt_tpu_torch.core.config import default_config
from salt_tpu_torch.data import bundle
from salt_tpu_torch.data import metadata

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

# seed 3 gives empty masks among the 6 train images
N_TRAIN, N_TEST, SEED = 6, 3, 3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tgs"))
    train_dir, test_dir, depths = write_synthetic_dataset(
        root, n_train=N_TRAIN, n_test=N_TEST, seed=SEED)
    return root, train_dir, test_dir, depths


def _path_flags(root, train_dir, test_dir, depths, csv):
    return ["--set", f"paths.train_images_dir={train_dir}",
            "--set", f"paths.test_images_dir={test_dir}",
            "--set", f"paths.depths_filepath={depths}",
            "--set", f"paths.metadata_filepath={csv}",
            "--set", f"paths.experiment_dir={os.path.join(root, 'exp')}"]


def test_generate_metadata_matches_jax(tree):
    _, train_dir, test_dir, depths = tree
    got = metadata.generate_metadata(train_dir, test_dir, depths)
    want = jax_metadata.generate_metadata(train_dir, test_dir, depths)
    pd.testing.assert_frame_equal(got, want)
    assert list(got.columns) == metadata.COLUMNS
    train = got[got["is_train"] == 1]
    assert len(train) == N_TRAIN and len(got) == N_TRAIN + N_TEST
    assert (train["size"] == 0).any() and (train["size"] > 0).any()
    assert got[got["is_train"] == 0]["size"].isna().all()


def test_generate_metadata_without_a_test_dir_matches_jax(tree, tmp_path):
    _, train_dir, _, depths = tree
    absent = str(tmp_path / "no_test")
    got = metadata.generate_metadata(train_dir, absent, depths)
    want = jax_metadata.generate_metadata(train_dir, absent, depths)
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == N_TRAIN and (got["is_train"] == 1).all()


def test_generate_metadata_stacking_matches_jax(tree, tmp_path):
    _, train_dir, test_dir, depths = tree
    csv = str(tmp_path / "metadata.csv")
    jax_metadata.generate_metadata(train_dir, test_dir, depths).to_csv(
        csv, index=None)
    preds = str(tmp_path / "joined")
    for colname in ("file_path_stacked_predictions", "stacked"):
        pd.testing.assert_frame_equal(
            metadata.generate_metadata_stacking(csv, preds, colname),
            jax_metadata.generate_metadata_stacking(csv, preds, colname))


def test_prepare_metadata_command_matches_jax_without_a_device(
        tree, tmp_path, monkeypatch, capsys):
    """No ``--device``, CUDA absent, and ``resolve_device`` never called:
    the port's command writes the JAX command's CSV byte for byte, and the
    port's loader reads it into the arrays the JAX loader does."""
    root, train_dir, test_dir, depths = tree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_device(*args, **kwargs):
        raise AssertionError("prepare-metadata resolved a device")

    monkeypatch.setattr(port_device, "resolve_device", no_device)
    port_csv, jax_csv = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    assert cli.main(["prepare-metadata", *_path_flags(
        root, train_dir, test_dir, depths, port_csv)]) == 0
    assert f"metadata saved to {port_csv}" in capsys.readouterr().out
    assert jax_cli.main(["prepare-metadata", *_path_flags(
        root, train_dir, test_dir, depths, jax_csv)]) == 0
    with open(port_csv, "rb") as a, open(jax_csv, "rb") as b:
        assert a.read() == b.read()

    cfg = default_config()
    cfg.paths.metadata_filepath = port_csv
    jax_cfg = jax_default_config()
    jax_cfg.paths.metadata_filepath = port_csv
    got_train, got_test = bundle.train_test_bundles(cfg)
    want_train, want_test = jax_bundle.train_test_bundles(jax_cfg)
    for got, want, n in ((got_train, want_train, N_TRAIN),
                         (got_test, want_test, N_TEST)):
        assert len(got) == n
        pd.testing.assert_frame_equal(got.meta, want.meta)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.depths, want.depths)
    np.testing.assert_array_equal(got_train.masks, want_train.masks)
    assert got_train.masks.max() == 1 and got_test.masks is None


def test_prepare_metadata_command_without_a_test_dir(tree, tmp_path):
    """The command on a tree with no test directory writes the train rows
    only, with the paths of the tree it was given."""
    root, train_dir, test_dir, depths = tree
    copy = str(tmp_path / "train")
    shutil.copytree(train_dir, copy)
    csv = str(tmp_path / "metadata.csv")
    flags = _path_flags(root, copy, str(tmp_path / "absent"), depths, csv)
    assert cli.main(["prepare-metadata", *flags]) == 0
    meta = pd.read_csv(csv)
    assert list(meta.columns) == metadata.COLUMNS
    assert len(meta) == N_TRAIN and (meta["is_train"] == 1).all()
    assert meta["file_path_image"].str.startswith(copy).all()
