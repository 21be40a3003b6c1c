"""The port's training loop and entry point against the JAX package, on
the CPU: the data order (K-fold split, shuffled batches, synthetic
data), the validation pass with its threshold sweep, the callbacks'
decisions, and ``cli train`` end to end, whose ``best.npz`` the JAX
package loads and the port's ``serve`` serves."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from torch_parity import (flagship_config, port_config, seeded_images,
                          seeded_jax_variables)

from salt_tpu.core.experiment import Experiment as JaxExperiment
from salt_tpu.data import kfold as jkfold
from salt_tpu.data import pipeline as jpipeline
from salt_tpu.data import synthetic as jsynthetic
from salt_tpu.train import callbacks as jcb
from salt_tpu.train.loop import validate as jax_validate
from salt_tpu.train.steps import SegmentationRunner as JaxRunner
from salt_tpu_torch import cli
from salt_tpu_torch.data import kfold, pipeline, synthetic
from salt_tpu_torch.models.convert import load_flax_flat
from salt_tpu_torch.models.registry import build_model
from salt_tpu_torch.train import callbacks as tcb
from salt_tpu_torch.train.loop import validate
from salt_tpu_torch.train.steps import SegmentationRunner


def test_kfold_and_batch_order_match_jax():
    z = np.random.RandomState(0).randint(50, 959, 97)
    for n_splits in (4, 6):
        got = list(kfold.KFoldBySortedValue(n_splits).split(z))
        want = list(jkfold.KFoldBySortedValue(n_splits).split(z))
        for (gt, gv), (wt, wv) in zip(got, want):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gv, wv)
    for shuffle in (True, False):
        got = list(pipeline.batch_indices(97, 24, shuffle,
                                          np.random.RandomState(5)))
        want = list(jpipeline.batch_indices(97, 24, shuffle,
                                            np.random.RandomState(5)))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("difficulty", ["easy", "hard", "real"])
def test_synthetic_arrays_are_bit_equal(difficulty):
    got = synthetic.synthetic_arrays(6, seed=3, difficulty=difficulty)
    want = jsynthetic.synthetic_arrays(6, seed=3, difficulty=difficulty)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_prefetch_keeps_order_and_runs_ahead():
    puts = []

    def put(*a):
        puts.append(a[0])
        return a

    out = []
    for (x,) in pipeline.prefetch_to_device(((i,) for i in range(4)), put):
        out.append(x)
        assert len(puts) == min(x + 2, 4)     # the next one is in flight
    assert out == [0, 1, 2, 3]


def test_validate_matches_jax():
    """Same weights, 10 images at inference batch 8 (a ragged, padded
    last batch): the sweep's threshold exactly, iou and iout to 1e-6,
    the mean validation loss to 1e-5."""
    cfg = flagship_config(depth=18, dtype="float32")
    cfg.training.batch_size_inference = 8
    jr = JaxRunner(cfg)
    variables, flat = seeded_jax_variables(jr.model, seed=6)
    jstate = jr.init_state(0).replace(params=variables["params"],
                                      batch_stats=variables["batch_stats"])
    images = seeded_images(10, seed=7)
    masks = (images > 150).astype(np.uint8)
    masks[:3] = 0                                     # empty masks too
    want = jax_validate(jr, jstate, images, masks, None)

    runner = SegmentationRunner(port_config(cfg), device="cpu")
    model = build_model(runner.config.model)
    load_flax_flat(model, flat)
    got = validate(runner, runner.train_state(model), images, masks)
    assert got["threshold"] == want["threshold"]
    for k in ("iou", "iout"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got, want)
    assert abs(got["sum"] - want["sum"]) <= 1e-5, (got, want)


class _RecordingExperiment:
    def __init__(self):
        self.saves = []

    def save_params_async(self, name, params, tag="best", meta=None):
        self.saves.append((name, tag, json.dumps(meta, sort_keys=True)))

    def flush_saves(self):
        pass

    def has_checkpoint(self, name, tag="best"):
        return False


class _State:
    """Enough of a train state for both packages' checkpoint callback."""
    params = batch_stats = opt_state = step = None

    def variables(self):
        return {}

    def last_arrays(self):
        return {}


def _drive(mod, scores):
    """One fit's worth of callback calls over a fixed metric sequence;
    returns every decision the callbacks took."""
    exp = _RecordingExperiment()
    cbs = mod.CallbackList([
        mod.ModelCheckpoint(exp, "network", metric_name="iout",
                            last_every=2),
        mod.ReduceLROnPlateauScheduler("iout", False, 0.1, 1, 1e-6),
        mod.ExponentialLRScheduler(0.9, epoch_every=2),
        mod.EarlyStopping("iout", patience=3),
        mod.TrainingMonitor(),
    ])
    ctx = {"state": _State(), "learning_rate": 1e-3, "epoch_id": 0,
           "batch_id": 0, "batch_loss": 0.0}
    cbs.on_train_begin(ctx)
    decisions = []
    for epoch, score in enumerate(scores):
        ctx["epoch_id"] = epoch
        cbs.on_epoch_begin(ctx)
        for b in range(2):
            ctx.update(batch_id=b, batch_loss=0.5 + epoch + b)
            cbs.on_batch_end(ctx)
        ctx["validation"] = {"iout": score, "threshold": 0.45, "sum": 1.0}
        cbs.on_epoch_end(ctx)
        lr = cbs.new_learning_rate(ctx)
        stop = cbs.training_break(ctx)
        decisions.append((epoch, ctx.get("train_loss"), lr, stop))
        if stop:
            break
    ctx["early_stopped"] = True
    cbs.on_train_end(ctx)
    return decisions, exp.saves


def test_callback_decisions_match_jax():
    scores = [0.5, 0.6, 0.6, 0.55, 0.61, 0.61, 0.6, 0.59, 0.58, 0.7]
    assert _drive(tcb, scores) == _drive(jcb, scores)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_train")
    exp = str(root / "exp")
    flags = ["--set", f"paths.experiment_dir={exp}",
             "--set", "model.encoder_depth=18",
             "--set", "training.dtype=float32",
             "--set", "training.batch_size_train=4",
             "--set", "training.batch_size_inference=4",
             "--set", "execution.n_cv_splits=4"]
    assert cli.main(["train", "--synthetic", "16", "--epochs", "1",
                     "--device", "cpu", *flags]) == 0
    return root, exp


def test_cli_train_writes_the_experiment(trained):
    _, exp = trained
    for rel in ("checkpoints/network/best.npz", "checkpoints/network/last.npz",
                "checkpoints/network/last.json", "config.json",
                "channels_network.jsonl"):
        assert os.path.exists(os.path.join(exp, rel)), rel
    with open(os.path.join(exp, "channels_network.jsonl")) as f:
        line = json.loads(f.readline())
    assert line["epoch"] == 0 and np.isfinite(line["train_loss"])
    with open(os.path.join(exp, "checkpoints/network/last.json")) as f:
        assert json.load(f)["finished"] is True


def test_port_best_npz_loads_into_the_jax_state(trained):
    _, exp = trained
    cfg = flagship_config(depth=18, dtype="float32")
    state = JaxRunner(cfg).init_state(0)
    like = {"params": state.params, "batch_stats": state.batch_stats}
    loaded = JaxExperiment(exp).load_params("network", like)
    want = jax.tree_util.tree_leaves(like)
    got = jax.tree_util.tree_leaves(loaded)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.shape(g) == np.shape(w) and np.asarray(g).dtype == w.dtype
    with np.load(os.path.join(exp, "checkpoints/network/best.npz")) as data:
        assert not any(k.startswith("torch_adam") for k in data.files)
        kernel = data["params/head/kernel"]
    np.testing.assert_array_equal(np.asarray(loaded["params"]["head"]["kernel"]),
                                  kernel)


def test_port_serves_its_trained_checkpoint(trained):
    from PIL import Image
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.pipeline.serving import serve
    root, exp = trained
    img_dir = root / "imgs"
    img_dir.mkdir(exist_ok=True)
    for i, img in enumerate(seeded_images(3, seed=8)):
        Image.fromarray(img).save(img_dir / f"t{i}.png")
    out = str(root / "sub.csv")
    result = serve(default_config(), exp, str(img_dir), out, device="cpu")
    assert result["n"] == 3
    with open(out) as f:
        assert len(f.read().splitlines()) == 4


def test_resume_continues_from_the_port_last_checkpoint(trained, tmp_path):
    """A second epoch from ``last``; a ``last`` with no optimizer state
    (neither the port's Adam state nor the optax state of one the JAX
    package wrote, which resumes: tests/test_torch_resume_jax.py) is
    refused with a clear message."""
    import shutil
    from salt_tpu_torch.core.experiment import Experiment, save_flat_npz
    from salt_tpu_torch.pipeline.api import load_last
    _, exp = trained
    copy = str(tmp_path / "exp")
    shutil.copytree(exp, copy)
    cfg = port_config(flagship_config(depth=18, dtype="float32"))
    runner = SegmentationRunner(cfg, device="cpu")
    state, next_epoch = load_last(runner, Experiment(copy), "network")
    assert next_epoch == 1 and state.step == 3     # 12 train images / 4
    p = Experiment(copy).checkpoint_path("network", "last")
    with np.load(p) as data:
        arrays = {k: data[k] for k in data.files
                  if not k.startswith("torch_adam")}
    save_flat_npz(p, arrays)
    with pytest.raises(ValueError, match="no optimizer state"):
        load_last(runner, Experiment(copy), "network")
    assert torch.isfinite(next(state.model.parameters())).all()


def test_metrics_match_jax():
    """The torch batch path and the numpy reference functions against
    ``salt_tpu.metrics.iout`` on masks with the empty-mask edge cases."""
    from salt_tpu.metrics import iout as jiout
    from salt_tpu_torch.metrics import iout
    rng = np.random.RandomState(9)
    gt = (rng.rand(6, 101, 101) > 0.7).astype(np.uint8)
    pred = (rng.rand(6, 101, 101) > 0.6).astype(np.uint8)
    gt[0] = pred[0] = 0                               # both empty
    gt[1] = 0                                         # gt empty only
    pred[2] = 0                                       # prediction empty only
    pred[3] = gt[3]                                   # exact
    want_iou, want_iout = jiout.batch_iou_iout(gt, pred)
    got_iou, got_iout = iout.batch_iou_iout(torch.from_numpy(gt),
                                            torch.from_numpy(pred))
    np.testing.assert_array_equal(got_iou.numpy(), np.asarray(want_iou))
    np.testing.assert_array_equal(got_iout.numpy(), np.asarray(want_iout))
    for a, b in zip(iout.batch_iou_iout_np(gt, pred),
                    jiout.batch_iou_iout_np(gt, pred)):
        np.testing.assert_array_equal(a, b)
    assert iout.IOUT_THRESHOLDS == jiout.IOUT_THRESHOLDS
    assert (iout.intersection_over_union_thresholds(gt, pred)
            == jiout.intersection_over_union_thresholds(gt, pred))
    assert (iout.intersection_over_union(gt, pred)
            == jiout.intersection_over_union(gt, pred))
    assert iout.iou(gt[4], pred[4]) == jiout.iou(gt[4], pred[4])


def test_bundles_load_from_disk_as_in_jax(tmp_path):
    """The on-disk layout (PNG images and masks, metadata.csv) packs into
    the same arrays in both packages, dev-mode sampling included."""
    from salt_tpu.data.bundle import train_test_bundles as jax_bundles
    from salt_tpu.data.metadata import generate_metadata
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.data.bundle import train_test_bundles
    train_dir, test_dir, depths = jsynthetic.write_synthetic_dataset(
        str(tmp_path), n_train=12, n_test=4, seed=2)
    meta = generate_metadata(train_dir, test_dir, depths)
    meta_path = str(tmp_path / "metadata.csv")
    meta.to_csv(meta_path, index=False)
    for dev_mode in (False, True):
        cfg = default_config()
        cfg.paths.metadata_filepath = meta_path
        cfg.execution.dev_mode = dev_mode
        cfg.execution.dev_mode_size = 5
        jcfg = flagship_config()
        jcfg.paths.metadata_filepath = meta_path
        jcfg.execution.dev_mode = dev_mode
        jcfg.execution.dev_mode_size = 5
        got, want = train_test_bundles(cfg), jax_bundles(jcfg)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.images, w.images)
            np.testing.assert_array_equal(g.depths, w.depths)
            if w.masks is None:
                assert g.masks is None
            else:
                np.testing.assert_array_equal(g.masks, w.masks)
            assert list(g.meta["id"]) == list(w.meta["id"])
