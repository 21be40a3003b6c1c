"""The port's serving pieces on their own (CPU, small UNetResNet18):
checkpoint resolution, config adoption, the probability archive, RLE
parity with the JAX package's codec, chunked streaming, and the CLI."""
import json
import os
import threading

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


def _scratch_int8_config():
    cfg = default_config()
    cfg.model.architecture = "SaltUNet"
    cfg.model.n_filters = 4
    cfg.model.repeat_blocks = 2
    cfg.model.quant_bits = 8
    cfg.training.dtype = "float32"
    cfg.training.batch_size_inference = 2
    cfg.postpro.use_tta = True
    cfg.postpro.tta_flip_lr = True
    return cfg


@pytest.fixture
def cv_experiment(tmp_path):
    """A CV experiment dir of 3 fold checkpoints (SaltUNet, 4 filters)
    and a directory of 5 PNGs."""
    cfg = _scratch_int8_config()
    exp = str(tmp_path / "cv")
    for fold in range(3):
        model = init_seeded(build_model(cfg.model), seed=40 + fold)
        save_flat_npz(checkpoint_path(exp, f"network_fold_{fold}"),
                      to_flax_flat(model))
    from PIL import Image
    (tmp_path / "imgs").mkdir()
    for i, img in enumerate(seeded_images(5, seed=41)):
        Image.fromarray(img).save(tmp_path / "imgs" / f"im{i}.png")
    return exp, str(tmp_path / "imgs")


def test_fold_pipeline_serves_as_restore_per_fold(cv_experiment, tmp_path):
    """Restoring on the worker thread changes nothing served: the CSV is
    the one of ``runner.restore`` per fold and the same TTA step, the
    provenance holds each file's ``file_sha256``, and the spans and
    counters read one restore a fold (3 chunks reuse the placed
    models)."""
    from salt_tpu_torch.core import tracing
    from salt_tpu_torch.ops.rle import create_submission
    from salt_tpu_torch.pipeline.quality import file_sha256
    from salt_tpu_torch.train.steps import SegmentationRunner
    exp, img_dir = cv_experiment
    cfg = _scratch_int8_config()
    csv = str(tmp_path / "sub.csv")
    with tracing.session() as rec:
        result = serving.serve(cfg, exp, img_dir, csv, chunk_size=2,
                               device="cpu")

    ckpts = serving.resolve_checkpoints(exp)
    runner = SegmentationRunner(cfg, "cpu")
    ids, paths = serving.list_images(img_dir)
    images = torch.from_numpy(serving.decode_images(paths))
    acc = 0
    for c in ckpts:
        model = runner.restore(c)
        acc = acc + torch.cat([runner.predict_tta_step(model, images[i:i + 2])
                               [:, 1] for i in range(0, 5, 2)])
    masks = (acc / len(ckpts) > cfg.postpro.threshold_masks).to(torch.uint8)
    want = create_submission(pd.DataFrame({"id": ids}), list(masks.numpy()))
    got = pd.read_csv(csv, keep_default_na=False)
    pd.testing.assert_frame_equal(got, want.astype(got.dtypes.to_dict()))
    assert masks.sum() > 0

    with open(result["int8_provenance"]) as f:
        prov = json.load(f)
    assert prov["checkpoints"] == [{"path": c, "sha256": file_sha256(c)}
                                   for c in ckpts]
    restores = rec.named("serve.restore")
    assert [s.attrs["fold"] for s in restores] == [0, 1, 2]
    assert 0 <= rec.counters["serve.restores_ready"] <= 3
    # 3 chunks of 2, 2, 1 images (3 batches) through 3 folds
    assert (rec.counters["serve.forwards"] == result["batches"]
            == 3 * 3)


@pytest.mark.parametrize("broken", ["fold", "image"])
def test_failed_serve_raises_and_cleans_up(cv_experiment, tmp_path, broken):
    """A truncated fold 2 raises what ``runner.restore`` raises on it,
    after folds 0 and 1 ran; an unreadable image raises what its decode
    raises while the worker waits to run ahead. Either way: no CSV, no
    probability archive, no worker thread left."""
    from salt_tpu_torch.train.steps import SegmentationRunner
    exp, img_dir = cv_experiment
    cfg = _scratch_int8_config()
    if broken == "fold":
        bad = serving.resolve_checkpoints(exp)[2]
        with open(bad, "r+b") as f:
            f.truncate(os.path.getsize(bad) // 2)
        fail = lambda: SegmentationRunner(cfg, "cpu").restore(bad)
    else:
        bad = os.path.join(img_dir, "im9.png")
        with open(bad, "wb") as f:
            f.write(b"not a png")
        fail = lambda: serving.decode_images([bad])
    with pytest.raises(Exception) as direct:
        fail()
    threads = set(threading.enumerate())
    csv, probs = str(tmp_path / "sub.csv"), str(tmp_path / "p.npz")
    with pytest.raises(type(direct.value)):
        serving.serve(cfg, exp, img_dir, csv, probs, device="cpu")
    assert set(threading.enumerate()) == threads
    assert not os.path.exists(csv) and not os.path.exists(probs)


def test_restore_is_place_of_restore_host(experiment):
    """``restore`` stays ``place`` of the host half (bf16 serving cast
    included), also loaded into an uninitialised copy of one build as the
    serve worker does, and the worker's one read gives ``load_flat_npz``'s
    arrays and ``file_sha256``'s digest."""
    from salt_tpu_torch.core.experiment import load_flat_npz, read_flat_npz
    from salt_tpu_torch.pipeline.quality import file_sha256
    from salt_tpu_torch.train.steps import SegmentationRunner
    exp_dir, _ = experiment
    path = serving.resolve_checkpoints(exp_dir)[0]
    cfg = _small_config()
    cfg.training.dtype = "bfloat16"
    runner = SegmentationRunner(cfg, "cpu")
    arrays, sha = read_flat_npz(path)
    assert sha == file_sha256(path)
    want = load_flat_npz(path)
    assert arrays.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(arrays[k], want[k])
        assert arrays[k].dtype == want[k].dtype
    a = runner.restore(path).state_dict()
    # the serve worker's form: an uninitialised copy of one build
    template = runner.build()
    for host in (runner.restore_host(path), runner.restore_host(arrays),
                 runner.restore_host(arrays, serving._empty_copy(template))):
        b = runner.place(host).state_dict()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_fold_models_stay_within_their_lookahead(tmp_path):
    """The worker and the fold loop under a short switch interval: the
    worker never holds more than two unplaced folds, folds come in order
    and stay placed, the hashes are each file's, and no thread is left."""
    import sys
    import time
    from salt_tpu_torch.pipeline.quality import file_sha256
    paths = []
    for k in range(16):
        paths.append(str(tmp_path / f"f{k}.npz"))
        np.savez(paths[-1], x=np.full(3, k))

    class Runner:
        def __init__(self):
            self.lock = threading.Lock()
            self.started = self.placed = self.worst = 0

        def build(self):
            return torch.nn.Module()

        def restore_host(self, arrays, model):
            assert isinstance(model, torch.nn.Module)
            with self.lock:
                self.started += 1
                self.worst = max(self.worst, self.started - self.placed)
            return int(arrays["x"][0])

        def place(self, k):
            time.sleep(0.001 * (k % 3))
            with self.lock:
                self.placed += 1
            return k

    runner, out = Runner(), {}

    def loop():
        with serving._FoldModels(runner, paths) as models:
            out["first"] = [models[k] for k in range(16)]
            out["again"] = [models[k] for k in range(16)]
        out["hashes"], out["worker"] = models.hashes, models._worker

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=loop, daemon=True)
        t.start()
        t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not t.is_alive()
    assert out["first"] == out["again"] == list(range(16))
    assert runner.worst <= serving._FoldModels.AHEAD == 2
    assert runner.placed == 16
    assert out["hashes"] == {p: file_sha256(p) for p in paths}
    assert not out["worker"].is_alive()


@pytest.mark.parametrize("form", ["stored", "compressed", "damaged"])
def test_read_flat_npz_is_load_flat_npz(tmp_path, form):
    """One read gives ``load_flat_npz``'s arrays (C and Fortran order, 0-d,
    int; stored members as views, compressed ones inflated) and
    ``file_sha256``'s digest; a damaged stored member raises what
    ``load_flat_npz`` raises."""
    import zipfile
    from salt_tpu_torch.core.experiment import load_flat_npz, read_flat_npz
    from salt_tpu_torch.pipeline.quality import file_sha256
    arrays = {"params/a/kernel": np.arange(24, dtype=np.float32).reshape(
                  2, 3, 4),
              "params/a/bias": np.asfortranarray(
                  np.arange(6, dtype=np.float64).reshape(2, 3)),
              "params/a/prelu_alpha": np.float32(0.25),
              "step": np.int64(7)}
    path = save_flat_npz(str(tmp_path / "c.npz"), arrays,
                         compressed=form == "compressed")
    if form == "damaged":
        with open(path, "rb") as f:
            data = bytearray(f.read())
        data[data.index(np.float32(23).tobytes())] ^= 1
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(zipfile.BadZipFile):
            load_flat_npz(path)
        with pytest.raises(zipfile.BadZipFile):
            read_flat_npz(path)
        return
    got, sha = read_flat_npz(path)
    assert sha == file_sha256(path)
    want = load_flat_npz(path)
    assert got.keys() == want.keys() == arrays.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
