"""``serve --synthetic`` in the port against the JAX package's, on the
CPU: one command line, one shared SaltUNet ``best.npz`` and
``config.json`` (4 filters, 2 levels, fp32, hflip TTA). The ids must be
equal, and the masks must agree under the threshold-margin rule of
tests/test_submission_parity.py:161-193 (the fp32 probabilities within
1e-4, the masks equal wherever a pixel's margin from the threshold
exceeds that delta, at most 5 undecidable pixels). Without a checkpoint
both serve their runner's seeded initial weights, which the packages
draw differently: there the ids, the row count and determinism hold."""
import json
import os
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

from torch_parity import numpy_jax_variables, port_config

from salt_tpu.core.config import default_config as jax_default_config
from salt_tpu.core.experiment import Experiment
from salt_tpu.models.registry import build_model as jax_build_model
from salt_tpu.ops.rle import run_length_decoding

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

N = 8
SMALL = ["--set", "model.architecture=SaltUNet", "--set", "model.n_filters=4",
         "--set", "model.repeat_blocks=2", "--set", "training.dtype=float32",
         "--set", "training.batch_size_inference=4"]


def _masks(csv_path):
    sub = pd.read_csv(csv_path, keep_default_na=False)
    return sub["id"].tolist(), np.stack(
        [run_length_decoding(r, (101, 101)) for r in sub["rle_mask"]])


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """A JAX-written SaltUNet experiment dir, served by both CLIs."""
    root = tmp_path_factory.mktemp("serve_synthetic")
    cfg = jax_default_config()
    cfg.model.architecture = "SaltUNet"
    cfg.model.n_filters = 4
    cfg.model.repeat_blocks = 2
    cfg.training.dtype = "float32"
    cfg.training.batch_size_inference = 4
    jax_model = jax_build_model(cfg.model, "float32")
    variables, _ = numpy_jax_variables(jax_model, seed=9)
    exp = Experiment(str(root / "exp"))
    exp.save_params("network", variables)
    with open(os.path.join(exp.directory, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f)

    from salt_tpu import cli as jax_cli
    from salt_tpu_torch import cli
    line = ["serve", "--checkpoint", exp.directory, "--synthetic", str(N)]
    jax_csv, port_csv = str(root / "jax.csv"), str(root / "port.csv")
    assert jax_cli.main([*line, "--out", jax_csv]) == 0
    assert cli.main([*line, "--out", port_csv, "--device", "cpu"]) == 0

    # the fp32 probabilities of both packages on the served images
    from salt_tpu.data.bundle import synthetic_bundle as jax_bundle
    from salt_tpu.train.steps import SegmentationRunner as JaxRunner
    from salt_tpu_torch.data.bundle import synthetic_bundle
    from salt_tpu_torch.train.steps import SegmentationRunner
    images = jax_bundle(N, seed=cfg.execution.seed, with_masks=False).images
    port_images = synthetic_bundle(N, seed=cfg.execution.seed,
                                   with_masks=False).images
    np.testing.assert_array_equal(port_images, images)
    p_jax = JaxRunner(cfg).predict_dataset(
        SimpleNamespace(**variables), images, tta=True)[:, 1]
    runner = SegmentationRunner(port_config(cfg), device="cpu")
    model = runner.restore(exp.checkpoint_path("network"))
    p_port = runner.predict_dataset(model, images, tta=True)[:, 1]
    return dict(jax_csv=jax_csv, port_csv=port_csv, p_jax=p_jax,
                p_port=p_port)


def test_same_ids_and_masks_as_jax_under_the_margin_rule(shared):
    ids_j, masks_j = _masks(shared["jax_csv"])
    ids_p, masks_p = _masks(shared["port_csv"])
    assert ids_j == ids_p and len(ids_p) == N
    p_jax = shared["p_jax"]
    delta = float(np.abs(shared["p_port"] - p_jax).max())
    assert delta < 1e-4, f"probability delta vs JAX: {delta}"
    assert masks_p.any() and not masks_p.all()
    decidable = np.abs(p_jax - 0.5) > delta
    assert int((~decidable).sum()) <= 5
    np.testing.assert_array_equal(masks_p[decidable], masks_j[decidable])
    # the port's masks are its own probabilities thresholded
    np.testing.assert_array_equal(masks_p, shared["p_port"] > 0.5)


def test_seeded_weights_without_a_checkpoint(tmp_path, capsys):
    """No checkpoint: the runner's seeded initial weights, the same CSV
    twice, JAX's ids; ``--images-dir`` is ignored."""
    from salt_tpu import cli as jax_cli
    from salt_tpu_torch import cli
    outs = []
    for i in range(2):
        out = str(tmp_path / f"port{i}.csv")
        assert cli.main(["serve", "--synthetic", str(N), "--out", out,
                         "--images-dir", str(tmp_path / "missing"),
                         "--device", "cpu", *SMALL]) == 0
        with open(out) as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    printed = capsys.readouterr().out
    assert "'n': 8" in printed and "'warmup_batches': 2" in printed
    jax_out = str(tmp_path / "jax.csv")
    assert jax_cli.main(["serve", "--synthetic", str(N), "--out", jax_out,
                         *SMALL]) == 0
    ids_p, masks_p = _masks(str(tmp_path / "port0.csv"))
    ids_j, masks_j = _masks(jax_out)
    assert ids_p == ids_j and masks_p.shape == masks_j.shape


def test_ragged_chunks_of_in_memory_images(tmp_path):
    """10 images in chunks of 4 at batch 4: the last chunk is padded to a
    batch; the masks and probabilities equal one chunk's."""
    from salt_tpu_torch.core.config import load_config
    from salt_tpu_torch.pipeline.serving import serve
    cfg = load_config(None, {"model.architecture": "SaltUNet",
                             "model.n_filters": 4, "model.repeat_blocks": 2,
                             "training.dtype": "float32",
                             "training.batch_size_inference": 4})
    runs = []
    for chunk in (4, 8192):
        csv, probs = str(tmp_path / f"{chunk}.csv"), str(tmp_path / f"{chunk}")
        r = serve(cfg, "", "", csv, probs, synthetic=10, chunk_size=chunk,
                  device="cpu")
        assert r["n"] == 10 and r["batches"] == 3
        runs.append((pd.read_csv(csv, keep_default_na=False),
                     np.load(r["probs_out"], allow_pickle=True)["probs"]))
    pd.testing.assert_frame_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert runs[0][1].shape == (10, 101, 101)


def test_real_images_still_require_a_checkpoint(tmp_path):
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.pipeline.serving import serve
    with pytest.raises(ValueError, match="checkpoint"):
        serve(default_config(), "", str(tmp_path), synthetic=0,
              device="cpu")
