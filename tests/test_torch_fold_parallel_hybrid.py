"""``fit_fold_parallel`` over the hybrid fold x data mesh of 4 gloo
processes on the CPU (2 fold groups x 2 data ranks, SaltUNet 8 filters,
2 folds of 16 at batch 8, 2 epochs), as the JAX package's
``tests/test_fold_parallel.py:232-247`` runs its hybrid mesh: finite
losses for both folds in every epoch's record, each fold's validation,
and each fold's checkpoints and channels written once (by its group's
data rank 0)."""
import numpy as np


def _hybrid_fit(mesh, directory):
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.core.experiment import Experiment
    from salt_tpu_torch.data.bundle import synthetic_bundle
    from salt_tpu_torch.data.kfold import KFoldBySortedValue
    from salt_tpu_torch.parallel.fold_parallel import fit_fold_parallel
    cfg = default_config()
    cfg.model.architecture = "SaltUNet"
    cfg.model.n_filters = 8
    cfg.model.repeat_blocks = 2
    cfg.training.dtype = "float32"
    cfg.training.batch_size_train = 8
    cfg.training.batch_size_inference = 8
    cfg.parallel.fold_parallel_data_axis = 2
    bundle = synthetic_bundle(32, seed=3)
    splits = list(KFoldBySortedValue(n_splits=2).split(
        bundle.meta["z"].values))
    train = [(bundle.take(tr).images, bundle.take(tr).masks, None)
             for tr, _ in splits]
    valid = [(bundle.take(va).images, bundle.take(va).masks, None)
             for _, va in splits]
    states, history = fit_fold_parallel(
        cfg, train, epochs=2, valid_data=valid, seed=7, device="cpu",
        experiment=Experiment(directory),
        checkpoint_names=["network_fold_0", "network_fold_1"])
    return history, states.n_folds


def test_fit_fold_parallel_over_the_hybrid_mesh(tmp_path):
    from salt_tpu_torch.parallel.mesh import run_group
    history, local_folds = run_group(_hybrid_fit, 4, str(tmp_path))
    assert local_folds == 1                  # a fold group a fold
    assert [h["epoch"] for h in history] == [0, 1]
    for h in history:
        assert len(h["train_loss"]) == 2
        assert np.isfinite(h["train_loss"]).all()
        assert [v is not None for v in h["val"]] == [True, True]
    for i in range(2):
        lines = open(tmp_path / f"channels_network_fold_{i}.jsonl").readlines()
        assert len(lines) == 2               # one writer a fold group
        assert (tmp_path / "checkpoints" / f"network_fold_{i}"
                / "best.npz").exists()

