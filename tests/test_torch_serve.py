"""Serve end to end through both packages: the same JAX-saved 2-fold CV
experiment directory and the same directory of PNGs, hflip TTA, a ragged
last batch. The two ``submission.csv`` files are compared under the
threshold-margin rule of tests/test_submission_parity.py: the fp32
fold-mean probabilities must agree (delta < 1e-4); masks must be equal on
every pixel whose margin from the threshold exceeds the delta, with at
most 5 undecidable pixels; and the CSVs must be byte-equal whenever the
margin clears 10x the delta."""
import json
import os
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

from torch_parity import (flagship_config, port_config, seeded_images,
                          seeded_jax_variables)

from salt_tpu.core.experiment import Experiment
from salt_tpu.models.registry import build_model as jax_build_model
from salt_tpu.ops.rle import run_length_decoding
from salt_tpu.pipeline.serving import serve as jax_serve
from salt_tpu.train.steps import SegmentationRunner as JaxRunner
from salt_tpu_torch.pipeline.serving import serve
from salt_tpu_torch.train.steps import SegmentationRunner

N_IMAGES = 6
BATCH = 4


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    cfg = flagship_config(18)
    cfg.training.batch_size_inference = BATCH
    cfg.postpro.use_tta = True
    jax_model = jax_build_model(cfg.model, "float32")
    exp = Experiment(str(root / "cv"))
    folds = []
    for fold in range(2):
        variables, _ = seeded_jax_variables(jax_model, seed=10 + fold)
        exp.save_params(f"network_fold_{fold}", variables)
        folds.append(variables)
    with open(os.path.join(exp.directory, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f)

    from PIL import Image
    images = seeded_images(N_IMAGES, seed=12)
    img_dir = root / "images"
    img_dir.mkdir()
    for i, img in enumerate(images):
        Image.fromarray(img).save(img_dir / f"img_{i:02d}.png")

    jax_csv = str(root / "jax.csv")
    port_csv = str(root / "port.csv")
    jax_serve(cfg, exp.directory, str(img_dir), jax_csv)
    result = serve(port_config(cfg), exp.directory, str(img_dir), port_csv,
                   device="cpu")

    # fp32 fold-mean probabilities of both packages, same images
    jax_runner = JaxRunner(cfg)
    p_jax = np.mean([jax_runner.predict_dataset(
        SimpleNamespace(**v), images, tta=True)[:, 1] for v in folds], axis=0)
    runner = SegmentationRunner(port_config(cfg), device="cpu")
    models = [runner.restore(c) for c in sorted(
        exp.checkpoint_path(f"network_fold_{i}") for i in range(2))]
    p_port = (runner.predict_dataset(models[0], images, tta=True)[:, 1]
              + runner.predict_dataset(models[1], images, tta=True)[:, 1]) / 2
    return dict(jax_csv=jax_csv, port_csv=port_csv, result=result,
                p_jax=p_jax, p_port=p_port)


def _masks(csv_path):
    sub = pd.read_csv(csv_path, keep_default_na=False)
    return sub["id"].tolist(), np.stack(
        [run_length_decoding(r, (101, 101)) for r in sub["rle_mask"]])


def test_serve_result_contract(served):
    r = served["result"]
    assert r["n"] == N_IMAGES and r["submission"] == served["port_csv"]
    assert r["images_per_sec"] > 0
    n_batches = -(-N_IMAGES // BATCH)
    assert r["batches"] == 2 * n_batches
    assert r["warmup_batches"] == n_batches


def test_port_serve_masks_are_its_fold_mean_threshold(served):
    """The port's serve == its own predict path, bit for bit: fp32 sum
    over folds / n_models, then > 0.5."""
    _, masks = _masks(served["port_csv"])
    np.testing.assert_array_equal(masks, served["p_port"] > 0.5)


def test_submission_matches_jax_under_margin_rule(served):
    ids_j, masks_j = _masks(served["jax_csv"])
    ids_p, masks_p = _masks(served["port_csv"])
    assert ids_j == ids_p
    p_jax = served["p_jax"]
    delta = float(np.abs(served["p_port"] - p_jax).max())
    margin = float(np.abs(p_jax - 0.5).min())
    assert delta < 1e-4, f"fold-mean probability delta vs JAX: {delta}"
    assert masks_p.any() and not masks_p.all()
    decidable = np.abs(p_jax - 0.5) > delta
    assert int((~decidable).sum()) <= 5
    np.testing.assert_array_equal(masks_p[decidable], masks_j[decidable])
    if margin > 10.0 * delta:
        with open(served["jax_csv"]) as a, open(served["port_csv"]) as b:
            assert a.read() == b.read()
