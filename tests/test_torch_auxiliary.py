"""The port's auxiliary small-mask crops against the JAX package's:
``get_cut_coordinates``, ``generate_auxiliary_bundle``,
``concat_bundles`` and ``auxiliary_rows_for_fold`` give JAX's results
on the same masks (where a split holds no crop's source the port's
returns an empty bundle and JAX's raises: ROADMAP.md Queue C), and with
``execution.use_auxiliary_data`` every CV fold (and the single-fold
``train``) fits on the same ids and images as JAX's (the fits
themselves are replaced by a recorder on both sides)."""
import numpy as np
import pytest
import torch

from salt_tpu.core.config import default_config
from salt_tpu.data import auxiliary as jax_aux
from salt_tpu.data.bundle import synthetic_bundle as jax_synthetic_bundle
from salt_tpu.pipeline import api as jax_api
from salt_tpu_torch.core.experiment import Experiment
from salt_tpu_torch.data import auxiliary
from salt_tpu_torch.data.bundle import synthetic_bundle
from salt_tpu_torch.pipeline import api

from torch_parity import port_config

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

N = 40


def _masks(seed):
    """Blob masks of every size class, seeded."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(12):
        yy, xx = np.mgrid[:101, :101]
        cy, cx = rng.randint(0, 101, 2)
        r = rng.randint(2, 40)
        out.append(((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.uint8))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_get_cut_coordinates_equals_jax(seed):
    for m in _masks(seed):
        for kw in ({}, {"step": 2, "min_size": 20, "max_size": 600}):
            assert (auxiliary.get_cut_coordinates(m, **kw)
                    == jax_aux.get_cut_coordinates(m, **kw))


def _assert_bundles_equal(p, j):
    assert p.meta.columns.tolist() == j.meta.columns.tolist()
    assert p.meta.astype(str).values.tolist() == \
        j.meta.astype(str).values.tolist()
    np.testing.assert_array_equal(p.images, j.images)
    np.testing.assert_array_equal(p.masks, j.masks)
    np.testing.assert_array_equal(p.depths, j.depths)


@pytest.fixture(scope="module")
def crops():
    port = auxiliary.generate_auxiliary_bundle(synthetic_bundle(N, seed=3))
    jax_ = jax_aux.generate_auxiliary_bundle(jax_synthetic_bundle(N, seed=3))
    return port, jax_


def test_generate_auxiliary_bundle_equals_jax(crops):
    port, jax_ = crops
    assert len(port) > 0 and port.images.dtype == np.uint8
    _assert_bundles_equal(port, jax_)


def test_concat_and_rows_for_fold_equal_jax(crops):
    port, jax_ = crops
    base_p, base_j = synthetic_bundle(6, seed=4), jax_synthetic_bundle(6, seed=4)
    valid = port.meta["source_id"].tolist()[::2] + ["not-an-id"]
    picked_p = auxiliary.auxiliary_rows_for_fold(port, valid)
    picked_j = jax_aux.auxiliary_rows_for_fold(jax_, valid)
    _assert_bundles_equal(picked_p, picked_j)
    _assert_bundles_equal(auxiliary.concat_bundles(base_p, picked_p),
                          jax_aux.concat_bundles(base_j, picked_j))
    # no crop of the split: an empty bundle, where JAX's raises
    empty = auxiliary.auxiliary_rows_for_fold(port, [])
    assert len(empty) == 0 and empty.images.shape == (0, 101, 101)
    assert auxiliary.concat_bundles(base_p, empty) is base_p
    with pytest.raises(IndexError):
        jax_aux.auxiliary_rows_for_fold(jax_, [])


def _record_fits(monkeypatch, module, predict_name):
    """Replace ``module``'s fold fit by a recorder of (name, train ids,
    train images) and its predictions by zeros."""
    fits = []

    def fake_fit(config, experiment, name, train_b, valid_b, runner=None):
        fits.append((name, train_b.meta["id"].tolist(), train_b.images.copy()))
        return runner

    def zeros(n):
        return np.zeros((n, 2, 101, 101), np.float32)

    monkeypatch.setattr(module, "_fit_fold", fake_fit)
    if predict_name == "_predict_bundle":
        monkeypatch.setattr(module, predict_name,
                            lambda runner, exp, name, b: zeros(len(b)))
    else:
        monkeypatch.setattr(module, predict_name,
                            lambda runner, exp, name, *bs: [zeros(len(b))
                                                            for b in bs])
    return fits


def test_cv_folds_train_on_jax_ids_with_auxiliary_data(monkeypatch, tmp_path):
    from salt_tpu.core.experiment import Experiment as JaxExperiment
    cfg = default_config()
    cfg.model.architecture = "SaltUNet"
    cfg.model.n_filters = 8
    cfg.training.dtype = "float32"
    cfg.execution.n_cv_splits = 2
    cfg.execution.use_auxiliary_data = True
    jax_fits = _record_fits(monkeypatch, jax_api, "_predict_bundle")
    port_fits = _record_fits(monkeypatch, api, "_predict_bundles")
    jax_api.train_evaluate_cv(cfg, JaxExperiment(str(tmp_path / "j")),
                              jax_synthetic_bundle(N, seed=3))
    pcfg = port_config(cfg)
    api.train_evaluate_cv(pcfg, Experiment(str(tmp_path / "p")),
                          synthetic_bundle(N, seed=3), device="cpu")
    jax_api.train(cfg, JaxExperiment(str(tmp_path / "j1")),
                  jax_synthetic_bundle(N, seed=3))
    api.train(pcfg, Experiment(str(tmp_path / "p1")),
              synthetic_bundle(N, seed=3), device="cpu")
    assert [f[0] for f in port_fits] == [f[0] for f in jax_fits] == [
        "network_fold_0", "network_fold_1", "network"]
    for (_, ids_p, img_p), (_, ids_j, img_j) in zip(port_fits, jax_fits):
        assert ids_p == ids_j
        assert any(i.startswith("aux_") for i in ids_p)
        np.testing.assert_array_equal(img_p, img_j)
