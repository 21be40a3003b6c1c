"""``--resume`` of the port's ``fit_fold_parallel`` on the CPU (SaltUNet,
8 filters, 2 levels, fp32, 2 folds of 16 synthetic images at batch 8),
as the JAX package's ``tests/test_fold_parallel.py`` holds its own: the
per-fold ``channels_<name>.jsonl`` and a resume that continues each
fold's parameters, Adam state and epoch (:157-185), a resume of a
finished run that changes nothing (:335-374), and one that keeps each
fold's schedule position (:465-490). The per-fold ``best.npz`` then
serves through the JAX package's ``serve``."""
import json

import numpy as np
import pytest
import torch

from torch_train_parity import fold_config as _cfg
from torch_train_parity import fold_splits as _fold_splits

from salt_tpu_torch.core.experiment import Experiment
from salt_tpu_torch.data.bundle import synthetic_bundle
from salt_tpu_torch.parallel.fold_parallel import fit_fold_parallel

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

NAMES = ["network_fold_0", "network_fold_1"]


def _fit(cfg, splits, experiment, epochs):
    fold_train, fold_valid = splits
    return fit_fold_parallel(cfg, fold_train, epochs=epochs,
                             valid_data=fold_valid, experiment=experiment,
                             checkpoint_names=NAMES,
                             seed=cfg.execution.seed, device="cpu")


def test_channels_and_resume_continue_each_fold(tmp_path):
    """Channels: an epoch line a fold and epoch, with the IOUT and the
    lr. Resume restores parameters, BN statistics, Adam moments, step
    and lr (the restored fold equals the saved ``last.npz``) and
    continues at the next epoch."""
    cfg = _cfg()
    splits = _fold_splits(synthetic_bundle(32, seed=13))
    experiment = Experiment(str(tmp_path / "exp"))
    states, _ = _fit(cfg, splits, experiment, 2)
    experiment.flush_saves()
    saved = [states.fold(i).last_arrays() for i in range(2)]
    for n in NAMES:
        lines = [json.loads(line) for line in
                 open(f"{experiment.directory}/channels_{n}.jsonl")]
        epochs = [line for line in lines if line.get("kind") == "epoch"]
        assert len(epochs) == 2
        assert "iout" in epochs[-1] and "lr" in epochs[-1]
        assert experiment.has_checkpoint(n, tag="last")

    from salt_tpu_torch.parallel.fold_parallel import (FoldParallelRunner,
                                                       _load_last_stacked)
    fp = FoldParallelRunner(cfg, 2, "cpu")
    restored = fp.init_states(cfg.execution.seed)
    next_epochs, _ = _load_last_stacked(fp, experiment, NAMES, restored)
    assert next_epochs == [2, 2]
    for i in range(2):
        got = restored.fold(i).last_arrays()
        assert set(got) == set(saved[i])
        for key, want in saved[i].items():
            np.testing.assert_array_equal(got[key], want, err_msg=key)

    cfg.execution.resume = True
    _, history = _fit(cfg, splits, experiment, 4)
    assert [h["epoch"] for h in history] == [2, 3]


def test_resume_of_a_finished_run_is_a_no_op(tmp_path):
    """No epoch trains, each fold's last meta keeps its epoch and the
    finished marker, and ``best`` is untouched byte for byte."""
    cfg = _cfg()
    splits = _fold_splits(synthetic_bundle(16, seed=17))
    experiment = Experiment(str(tmp_path / "exp"))
    _fit(cfg, splits, experiment, 2)
    experiment.flush_saves()
    last_meta = {n: experiment.load_meta(n, tag="last") for n in NAMES}
    best_meta = {n: experiment.load_meta(n, tag="best") for n in NAMES}
    best = {n: dict(np.load(experiment.checkpoint_path(n))) for n in NAMES}

    cfg.execution.resume = True
    _, history = _fit(cfg, splits, experiment, 2)
    experiment.flush_saves()
    assert history == []
    for n in NAMES:
        meta = experiment.load_meta(n, tag="last")
        assert meta["epoch"] == last_meta[n]["epoch"] == 1
        assert meta["finished"]
        assert experiment.load_meta(n, tag="best") == best_meta[n]
        after = dict(np.load(experiment.checkpoint_path(n)))
        for key in best[n]:
            np.testing.assert_array_equal(best[n][key], after[key])


def test_resume_restores_each_folds_schedule_lr(tmp_path):
    """Exponential schedule, gamma 0.5: after 2 epochs each fold's lr is
    lr0 / 4 and the resumed epoch starts there (a reset would show
    lr0)."""
    cfg = _cfg()
    cfg.training.lr_schedule = "exponential"
    cfg.training.gamma = 0.5
    splits = _fold_splits(synthetic_bundle(16, seed=23))
    experiment = Experiment(str(tmp_path / "exp"))
    _fit(cfg, splits, experiment, 2)

    cfg.execution.resume = True
    _, history = _fit(cfg, splits, experiment, 3)
    assert history[0]["epoch"] == 2
    for lr in history[0]["lr"]:
        assert lr == pytest.approx(cfg.training.lr * 0.25, rel=1e-6)


def test_fold_checkpoints_serve_in_the_jax_package(tmp_path):
    """Each fold's ``best.npz`` written by the port loads into the JAX
    package's runner and predicts what the port predicts from it, and
    the JAX ``serve`` ensembles the port's fold checkpoints."""
    from salt_tpu.core.config import default_config as jax_default_config
    from salt_tpu.pipeline.serving import _load_flat_npz
    from salt_tpu.pipeline.serving import serve as jax_serve
    from salt_tpu.train.steps import SegmentationRunner as JaxRunner
    from salt_tpu_torch.core.experiment import load_flat_npz
    from salt_tpu_torch.train.steps import SegmentationRunner
    cfg = _cfg()
    bundle = synthetic_bundle(16, seed=29)
    experiment = Experiment(str(tmp_path / "exp"))
    _fit(cfg, _fold_splits(bundle), experiment, 1)
    experiment.flush_saves()

    jcfg = jax_default_config()
    for section in ("model", "training", "execution"):
        for key, value in vars(getattr(cfg, section)).items():
            setattr(getattr(jcfg, section), key, value)
    jr = JaxRunner(jcfg)
    runner = SegmentationRunner(cfg, "cpu")
    images = bundle.images[:4]
    for n in NAMES:
        path = experiment.checkpoint_path(n)
        got = runner.predict_dataset(runner.restore(path), images)
        state = jr.init_state(0)
        tree = _load_flat_npz(path, {"params": state.params,
                                     "batch_stats": state.batch_stats})
        want = jr.predict_dataset(
            state.replace(params=tree["params"],
                          batch_stats=tree["batch_stats"]), images)
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3,
                                   err_msg=n)
        assert all(k.startswith(("params/", "batch_stats/"))
                   for k in load_flat_npz(path))
    out = jax_serve(jcfg, experiment.directory, "",
                    str(tmp_path / "sub.csv"), synthetic=8)
    assert out["n"] == 8
