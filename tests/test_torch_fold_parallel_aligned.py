"""Aligned fold-parallel training (``fit_fold_parallel(...,
align_with_sequential=True)``) against the port's sequential ``fit``,
fold by fold, on the CPU (SaltUNet, 8 filters, 2 levels, fp32, 2 folds
of 16 synthetic images at batch 8, 3 epochs): train loss rtol 1e-3 and
IOUT atol 1e-3 every epoch, as the JAX package's
``tests/test_fold_parallel.py:85-122``; here with channel dropout on,
its draws made before the step."""
import numpy as np
import torch

from torch_train_parity import fold_config as _cfg
from torch_train_parity import fold_splits as _fold_splits

from salt_tpu_torch.data.bundle import synthetic_bundle
from salt_tpu_torch.parallel.fold_parallel import fit_fold_parallel

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


def test_aligned_fold_parallel_matches_sequential_fit():
    """Aligned fold-parallel training equals the sequential loop's per
    epoch (same init, shuffles, augmentation and dropout draws), up to
    the batched numerics; channel dropout 0.3 on the bottom block."""
    from salt_tpu_torch.pipeline.api import _lr_schedule_callbacks
    from salt_tpu_torch.train.callbacks import CallbackList, EarlyStopping
    from salt_tpu_torch.train.loop import fit
    from salt_tpu_torch.train.steps import SegmentationRunner

    cfg = _cfg()
    cfg.model.dropout_2d = 0.3
    fold_train, fold_valid = _fold_splits(synthetic_bundle(32, seed=5))
    _, fp_history = fit_fold_parallel(cfg, fold_train, epochs=3,
                                      valid_data=fold_valid,
                                      seed=cfg.execution.seed,
                                      align_with_sequential=True,
                                      device="cpu")
    for i in range(2):
        runner = SegmentationRunner(cfg, "cpu")
        cbs = CallbackList([*_lr_schedule_callbacks(cfg.training),
                            EarlyStopping(cfg.training.validation_metric_name,
                                          cfg.training.patience, False)])
        _, seq_history = fit(runner, fold_train[i], fold_valid[i],
                             callbacks=cbs, seed=cfg.execution.seed,
                             epochs=3)
        for e in range(3):
            np.testing.assert_allclose(
                fp_history[e]["train_loss"][i],
                seq_history[e]["train_loss"], rtol=1e-3,
                err_msg=f"fold {i} epoch {e} loss diverged")
            np.testing.assert_allclose(
                fp_history[e]["val"][i]["iout"],
                seq_history[e]["val_iout"], atol=1e-3,
                err_msg=f"fold {i} epoch {e} iout diverged")
