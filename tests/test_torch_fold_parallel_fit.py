"""The port's ``fit_fold_parallel`` on the CPU (SaltUNet, 8 filters, 2
levels, fp32, 2 folds of 16 synthetic images at batch 8), the
counterpart of the JAX package's ``tests/test_fold_parallel.py``
(:45-221): the end-to-end fit and its per-fold checkpoints, no leak
between folds (:187-221), the ``lr_finder`` refusal, the hybrid mesh's
data axis in one process, and the CUDA default. Aligned training
against the sequential ``fit`` is in
``tests/test_torch_fold_parallel_aligned.py``, early stopping, the
plateau LR and ``--resume`` in ``tests/test_torch_fold_parallel_stop.py``
and ``tests/test_torch_fold_parallel_resume.py``."""
import numpy as np
import pytest
import torch

from torch_train_parity import fold_config as _cfg
from torch_train_parity import fold_splits as _fold_splits

from salt_tpu_torch.core.experiment import Experiment, add_fold_suffix
from salt_tpu_torch.data.bundle import synthetic_bundle
from salt_tpu_torch.data.kfold import KFoldBySortedValue
from salt_tpu_torch.parallel.fold_parallel import (FoldParallelRunner,
                                                   fit_fold_parallel)

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


def test_fit_fold_parallel_end_to_end(tmp_path):
    cfg = _cfg()
    fold_train, fold_valid = _fold_splits(synthetic_bundle(32, seed=21))
    names = [add_fold_suffix("network", i) for i in range(2)]
    experiment = Experiment(str(tmp_path / "exp"))
    states, history = fit_fold_parallel(cfg, fold_train, epochs=2,
                                        valid_data=fold_valid,
                                        experiment=experiment,
                                        checkpoint_names=names,
                                        device="cpu")
    assert len(history) == 2
    losses = np.asarray([h["train_loss"] for h in history])
    assert np.isfinite(losses).all() and losses.shape == (2, 2)
    assert "val" in history[-1] and len(history[-1]["val"]) == 2
    experiment.flush_saves()
    for n in names:
        assert experiment.has_checkpoint(n)
        assert experiment.has_checkpoint(n, tag="last")
    # distinct per-fold seeds: the folds' states differ
    p = states.params
    assert p.shape[0] == 2 and not torch.equal(p[0], p[1])


def test_no_cross_fold_leakage():
    """Fold 0's loss and new state do not move when fold 1's batch
    changes."""
    cfg = _cfg()
    bundle = synthetic_bundle(32, seed=5)
    cv = KFoldBySortedValue(n_splits=2)
    folds = [bundle.take(tr) for tr, _ in cv.split(bundle.meta["z"].values)]
    fp = FoldParallelRunner(cfg, 2, "cpu")
    b0 = (folds[0].images[:8], folds[0].masks[:8])
    b1 = (folds[1].images[:8], folds[1].masks[:8])
    out = {}
    for tag, other in [("same", b0), ("diff", b1)]:
        states = fp.init_states(1234, identical=True)
        di, dm = fp.shard_fold_batch(np.stack([b0[0], other[0]]),
                                     np.stack([b0[1], other[1]]))
        draws = fp.draw(torch.Generator().manual_seed(3), 8, aligned=True)
        loss = fp.train_step(states, di, dm, draws, [True, True])
        out[tag] = (loss, states.params[0].clone(), states.buffers[0].clone())
    assert out["same"][0][0] == out["diff"][0][0]
    assert out["same"][0][1] != out["diff"][0][1]
    assert torch.equal(out["same"][1], out["diff"][1])
    assert torch.equal(out["same"][2], out["diff"][2])


def test_lr_finder_is_refused():
    cfg = _cfg()
    cfg.training.lr_schedule = "lr_finder"
    fold_train, _ = _fold_splits(synthetic_bundle(16, seed=1))
    with pytest.raises(ValueError, match="lr_finder"):
        fit_fold_parallel(cfg, fold_train, epochs=1, device="cpu")


@pytest.mark.parametrize("knob,want", [(0, 1), (1, 1), (-1, 1)])
def test_data_axis_in_one_process(knob, want):
    """One process: the data axis is 1 (auto resolves to 1); every fold
    trains here."""
    cfg = _cfg()
    cfg.parallel.fold_parallel_data_axis = knob
    fp = FoldParallelRunner(cfg, 6, "cpu")
    assert fp.n_data == want
    assert fp.mesh_shape == {"fold": 1, "data": 1}
    assert fp.folds == list(range(6))


def test_data_axis_above_the_world_size_raises():
    cfg = _cfg()
    cfg.parallel.fold_parallel_data_axis = 2
    with pytest.raises(ValueError, match="fold_parallel_data_axis=2 exceeds"):
        FoldParallelRunner(cfg, 2, "cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FoldParallelRunner(_cfg(), 2)
    fold_train, _ = _fold_splits(synthetic_bundle(16, seed=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_fold_parallel(_cfg(), fold_train, epochs=1)
