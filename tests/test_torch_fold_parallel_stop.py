"""Early stopping and the per-fold LR plateau of the port's
``fit_fold_parallel`` on the CPU (SaltUNet, 8 filters, 2 levels, fp32,
2 folds at batch 8), and ``--resume`` around a fold that stopped, as the
JAX package's ``tests/test_fold_parallel.py`` holds its own: stopped
folds freeze and the loop ends when all have (:125-137), plateau
annealing per fold (:140-154), a resume with a larger budget leaves
early-stopped folds frozen byte for byte (:377-413), and a partial
resume trains the fold that had no checkpoint while the finished one
stays as it was (:416-462)."""
import shutil

import numpy as np
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


def _fit(cfg, splits, epochs, experiment=None):
    fold_train, fold_valid = splits
    return fit_fold_parallel(
        cfg, fold_train, epochs=epochs, valid_data=fold_valid,
        experiment=experiment,
        checkpoint_names=NAMES if experiment is not None else None,
        seed=cfg.execution.seed, device="cpu")


def test_fold_parallel_early_stop_freezes_and_breaks():
    """patience 0: folds stop as soon as the metric fails to improve, a
    stopped fold's parameters no longer move, and the loop ends once
    every fold has stopped."""
    cfg = _cfg()
    cfg.training.patience = 0
    states, history = _fit(cfg, _fold_splits(synthetic_bundle(32, seed=9)),
                           30)
    assert len(history) < 30, "early stopping never fired"
    assert not all(history[-1]["active"])
    # a fold frozen in the last epoch took fewer steps
    assert states.steps.min() < states.steps.max()


def test_fold_parallel_plateau_lr_anneals():
    """reduce_patience 0 and a stalling metric anneal the folds' lrs, each
    on its own schedule."""
    cfg = _cfg()
    cfg.training.reduce_patience = 0
    cfg.training.reduce_factor = 0.5
    cfg.training.patience = 100
    _, history = _fit(cfg, _fold_splits(synthetic_bundle(16, seed=11)), 6)
    assert min(history[-1]["lr"]) < cfg.training.lr


def _stopped_run(tmp_path):
    cfg = _cfg()
    cfg.training.patience = 0
    splits = _fold_splits(synthetic_bundle(16, seed=19))
    experiment = Experiment(str(tmp_path / "exp"))
    _, history = _fit(cfg, splits, 30, experiment)
    assert len(history) < 30, "early stopping never fired"
    experiment.flush_saves()
    for n in NAMES:
        meta = experiment.load_meta(n, tag="last")
        assert meta["finished"] and meta["early_stopped"]
    return cfg, splits, experiment


def test_resume_keeps_early_stopped_folds_frozen(tmp_path):
    cfg, splits, experiment = _stopped_run(tmp_path)
    last = {n: dict(np.load(experiment.checkpoint_path(n, tag="last")))
            for n in NAMES}
    cfg.execution.resume = True
    _, history = _fit(cfg, splits, 60, experiment)
    experiment.flush_saves()
    assert history == []
    for n in NAMES:
        meta = experiment.load_meta(n, tag="last")
        assert meta["finished"] and meta["early_stopped"]
        after = dict(np.load(experiment.checkpoint_path(n, tag="last")))
        for key in last[n]:
            np.testing.assert_array_equal(last[n][key], after[key])


def test_partial_resume_trains_the_fold_without_a_checkpoint(tmp_path):
    cfg, splits, experiment = _stopped_run(tmp_path)
    # the crash window: fold 1 never reached a checkpoint save
    shutil.rmtree(experiment.checkpoint_dir(NAMES[1]))
    before = {tag: dict(np.load(experiment.checkpoint_path(NAMES[0],
                                                           tag=tag)))
              for tag in ("last", "best")}
    cfg.execution.resume = True
    _, history = _fit(cfg, splits, 2, experiment)
    experiment.flush_saves()
    assert history, "the fresh fold must train on resume"
    assert all(not h["active"][0] and h["active"][1] for h in history)
    meta0 = experiment.load_meta(NAMES[0], tag="last")
    assert meta0["finished"] and meta0["early_stopped"]
    for tag, arrays in before.items():
        after = dict(np.load(experiment.checkpoint_path(NAMES[0], tag=tag)))
        for key in arrays:
            np.testing.assert_array_equal(arrays[key], after[key])
    assert experiment.has_checkpoint(NAMES[1])
    assert experiment.load_meta(NAMES[1], tag="last").get("finished")
