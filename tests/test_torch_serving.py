"""The port's serving pieces on their own (CPU, small UNetResNet18):
checkpoint resolution, config adoption, the probability archive, RLE
parity with the JAX package's codec, chunked streaming, and the CLI."""
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from torch_parity import seeded_images

from salt_tpu_torch.core.config import default_config
from salt_tpu_torch.core.experiment import checkpoint_path, save_flat_npz
from salt_tpu_torch.models.convert import to_flax_flat
from salt_tpu_torch.models.registry import build_model, init_seeded
from salt_tpu_torch.pipeline import serving

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


def _small_config():
    cfg = default_config()
    cfg.model.encoder_depth = 18
    cfg.training.dtype = "float32"
    cfg.training.batch_size_inference = 2
    return cfg


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A single-network experiment dir saved by the port, with its
    config.json, and a directory of 5 PNGs."""
    root = tmp_path_factory.mktemp("port_serve")
    cfg = _small_config()
    model = init_seeded(build_model(cfg.model), seed=21)
    save_flat_npz(checkpoint_path(str(root / "exp")), to_flax_flat(model))
    with open(root / "exp" / "config.json", "w") as f:
        json.dump(cfg.to_dict(), f)
    from PIL import Image
    (root / "imgs").mkdir()
    for i, img in enumerate(seeded_images(5, seed=22)):
        Image.fromarray(img).save(root / "imgs" / f"im{i}.png")
    return str(root / "exp"), str(root / "imgs")


def test_resolve_checkpoints(tmp_path):
    p = tmp_path / "best.npz"
    np.savez(p, x=np.zeros(1))
    assert serving.resolve_checkpoints(str(p)) == [str(p)]
    for i in (1, 0):
        save_flat_npz(checkpoint_path(str(tmp_path / "cv"),
                                      f"network_fold_{i}"), {"x": np.zeros(1)})
    got = serving.resolve_checkpoints(str(tmp_path / "cv"))
    assert [os.path.basename(os.path.dirname(g)) for g in got] == [
        "network_fold_0", "network_fold_1"]
    with pytest.raises(FileNotFoundError):
        serving.resolve_checkpoints(str(tmp_path / "missing"))


def test_adopts_trained_config_and_user_set_wins(experiment):
    exp_dir, _ = experiment
    cfg = default_config()
    cfg.model.quant_bits = 8
    serving.adopt_checkpoint_config(cfg, exp_dir,
                                    user_set=("training.dtype",))
    assert cfg.model.encoder_depth == 18           # adopted
    assert cfg.training.dtype == "bfloat16"        # --set kept
    assert cfg.model.quant_bits == 8               # serving choice kept


def test_rle_matches_jax_codec():
    from salt_tpu.ops import rle as jax_rle
    from salt_tpu_torch.ops import rle
    masks = np.random.RandomState(0).rand(4, 101, 101) > 0.7
    masks[0] = False
    for m in masks:
        assert rle.run_length_encoding(m) == jax_rle.run_length_encoding(m)
        enc = " ".join(map(str, rle.run_length_encoding(m)))
        np.testing.assert_array_equal(
            jax_rle.run_length_decoding(enc, (101, 101)), m)
    ids = pd.DataFrame({"id": ["a", "b", "c", "d"]})
    pd.testing.assert_frame_equal(rle.create_submission(ids, list(masks)),
                                  jax_rle.create_submission(ids, list(masks)))


def test_probs_writer_streams_and_cleans_up(tmp_path):
    path = str(tmp_path / "p")
    w = serving._ProbsWriter(path, ["a", "b"], (101, 101))
    w.append(np.full((1, 101, 101), 0.25, np.float16))
    w.append(np.full((1, 101, 101), 0.75, np.float16))
    w.close()
    data = np.load(path + ".npz", allow_pickle=True)
    assert list(data["ids"]) == ["a", "b"] and data["probs"].shape == (2, 101, 101)
    w = serving._ProbsWriter(path, ["a", "b"], (101, 101))
    w.append(np.zeros((1, 101, 101), np.float16))
    with pytest.raises(RuntimeError, match="incomplete"):
        w.close()
    assert not os.path.exists(path + ".npz")


def test_serve_streams_chunks_identically(experiment, tmp_path):
    """Chunks smaller than the dataset (ragged, streamed decode) give the
    same submission and probabilities as one chunk."""
    exp_dir, img_dir = experiment
    outs = []
    for chunk in (2, 4096):
        csv = str(tmp_path / f"s{chunk}.csv")
        probs = str(tmp_path / f"p{chunk}.npz")
        r = serving.serve(_small_config(), exp_dir, img_dir, csv, probs,
                          chunk_size=chunk, device="cpu")
        assert r["n"] == 5 and r["probs_out"] == probs
        outs.append((pd.read_csv(csv, keep_default_na=False),
                     np.load(probs, allow_pickle=True)["probs"]))
    pd.testing.assert_frame_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert outs[0][1].shape == (5, 101, 101)


def test_cli_serve_on_cpu(experiment, tmp_path, capsys):
    from salt_tpu_torch import cli
    exp_dir, img_dir = experiment
    out = str(tmp_path / "cli.csv")
    assert cli.main(["serve", "--checkpoint", exp_dir, "--images-dir",
                     img_dir, "--out", out, "--no-tta", "--device", "cpu",
                     "--set", "training.batch_size_inference=4"]) == 0
    sub = pd.read_csv(out, keep_default_na=False)
    assert list(sub.columns) == ["id", "rle_mask"] and len(sub) == 5
    assert "'n': 5" in capsys.readouterr().out


def test_serve_requires_checkpoint(tmp_path):
    with pytest.raises(ValueError, match="checkpoint"):
        serving.serve(_small_config(), "", str(tmp_path), device="cpu")
