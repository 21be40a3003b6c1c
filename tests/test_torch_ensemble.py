"""The port's ``ensemble_experiments`` against the JAX package's on the
same persisted predictions (three experiment dirs written by the JAX
package, ids in different orders, one id missing from one member): the
same submission CSV and the same oof scores for mean, gmean and
weights; the ``ensemble`` command touches no device."""
import filecmp

import numpy as np
import pytest
import torch

from salt_tpu.core.experiment import Experiment as JaxExperiment
from salt_tpu.data.bundle import synthetic_bundle as jax_synthetic_bundle
from salt_tpu.pipeline.ensemble import \
    ensemble_experiments as jax_ensemble_experiments
from salt_tpu_torch.core.config import default_config
from salt_tpu_torch.data.bundle import synthetic_bundle
from salt_tpu_torch.pipeline.ensemble import (average_probabilities,
                                              ensemble_experiments)

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

N = 12


@pytest.fixture(scope="module")
def members(tmp_path_factory):
    root = tmp_path_factory.mktemp("ensemble")
    seed = default_config().execution.seed
    train_ids = jax_synthetic_bundle(N, seed=seed).meta["id"].tolist()
    test_ids = jax_synthetic_bundle(8, seed=seed + 1,
                                    with_masks=False).meta["id"].tolist()
    rng = np.random.RandomState(0)
    dirs = []
    for e in range(3):
        d = str(root / f"exp{e}")
        exp = JaxExperiment(d)
        for name, ids in (("out_of_fold_train_predictions", train_ids),
                          ("out_of_fold_test_predictions", test_ids)):
            order = rng.permutation(len(ids))[:len(ids) - (e == 2)]
            # smooth maps so the threshold cuts blobs
            field = rng.rand(len(order), 2, 13, 13)
            probs = np.repeat(np.repeat(field, 8, axis=2), 8, axis=3)
            exp.save_predictions(name, [ids[k] for k in order],
                                 probs[..., :101, :101].astype(np.float32))
        dirs.append(d)
    return dict(root=root, dirs=dirs, seed=seed)


@pytest.mark.parametrize("method,weights", [("mean", None),
                                            ("gmean", None),
                                            ("mean", [1.0, 2.0, 0.5])])
def test_ensemble_equals_jax(members, tmp_path, method, weights):
    seed = members["seed"]
    out_j, out_p = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    want = jax_ensemble_experiments(members["dirs"], out_j,
                                    jax_synthetic_bundle(N, seed=seed),
                                    weights=weights, method=method)
    got = ensemble_experiments(members["dirs"], out_p,
                               synthetic_bundle(N, seed=seed),
                               weights=weights, method=method)
    assert filecmp.cmp(out_j, out_p, shallow=False)
    want["submission_path"] = got["submission_path"]
    assert got == want
    assert len(got["member_oof_iout"]) == 3


def test_average_probabilities_refuses_bad_weights():
    stacked = np.random.RandomState(1).rand(2, 3, 2, 4, 4)
    with pytest.raises(ValueError, match="weights"):
        average_probabilities(stacked, [1.0])
    with pytest.raises(ValueError, match="non-negative"):
        average_probabilities(stacked, [1.0, -1.0])
    with pytest.raises(ValueError, match="method"):
        average_probabilities(stacked, method="median")


def test_ensemble_cli_touches_no_device(members, tmp_path, monkeypatch):
    from salt_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "sub.csv")
    assert cli.main(["ensemble", "--experiments", *members["dirs"][:2],
                     "--synthetic", str(N), "--out", out]) == 0
    ref = str(tmp_path / "ref.csv")
    jax_ensemble_experiments(members["dirs"][:2], ref, None)
    assert filecmp.cmp(out, ref, shallow=False)
