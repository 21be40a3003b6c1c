"""The port's stacking level against the JAX package's on the CPU
(StackingFCN, 32 filters, M = 3 first-level models, fp32).

- ``join_experiment_predictions`` and ``stacking_bundle`` over prediction
  files the JAX package wrote give JAX's ids and cube.
- The runner's train and inference inputs (the cube resized to 128, the
  mask resized and re-binarized, no augmentation) match JAX's
  ``StackingRunner._train_inputs`` / ``_infer_inputs`` to 1e-6.
- One train step from the same weights: the loss and the new BatchNorm
  statistics in fp32 (1e-5; the Lovász hinge takes the plain sort on the
  CPU), gradients and the Adam step in float64 by the rules of
  tests/test_torch_train_step.py (the head has 994 parameters, 12 of
  them, 1.2%, within the sign rule's band: the bound is 2%).
- ``train_evaluate_stacking``: ``training.stacking_epochs`` and
  ``stacking_lr`` set the level's own epochs and learning rate, the
  caller's config is left as it was, and the fold checkpoints it writes
  load in the JAX package (and a JAX-written one in the port), whose
  predictions agree within 2e-3; ``stacking-cv`` runs from the CLI.
"""
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import numpy_jax_variables, port_config
from torch_train_parity import (assert_step_matches, flatten_prefixed,
                                jax_float64_step, port_float64_step)

from salt_tpu.core.config import default_config
from salt_tpu.core.experiment import Experiment as JaxExperiment
from salt_tpu.data.bundle import synthetic_bundle as jax_synthetic_bundle
from salt_tpu.models.stacking import StackingFCN as JaxStackingFCN
from salt_tpu.pipeline import stacking as jax_stacking
from salt_tpu.train.stacking import StackingRunner as JaxRunner
from salt_tpu_torch import cli
from salt_tpu_torch.core.experiment import Experiment
from salt_tpu_torch.data.bundle import synthetic_bundle
from salt_tpu_torch.models.convert import load_flax_flat, to_flax_flat
from salt_tpu_torch.models.registry import build_model
from salt_tpu_torch.pipeline import stacking
from salt_tpu_torch.train.stacking import StackingRunner

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

M = 3
B = 2
LR = 1e-4


def _config():
    cfg = default_config()
    cfg.model.architecture = "StackingFCN"
    cfg.model.input_model_nr = M
    cfg.training.dtype = "float32"
    cfg.training.lr = LR
    cfg.training.batch_size_train = 4
    cfg.training.batch_size_inference = 4
    cfg.execution.n_cv_splits = 2
    return cfg


def _cubes(n, seed):
    rng = np.random.RandomState(seed)
    field = rng.rand(n, 13, 13, M)
    up = np.repeat(np.repeat(field, 8, axis=1), 8, axis=2)[:, :101, :101]
    return np.clip(up + 0.1 * rng.rand(n, 101, 101, M), 0, 1).astype(
        np.float32)


def _write_first_level(root, bundle, n_exp=M, seed=0):
    """``n_exp`` experiment dirs of out-of-fold train predictions over the
    bundle's ids, written by the JAX package (each a different order)."""
    rng = np.random.RandomState(seed)
    ids = bundle.meta["id"].tolist()
    dirs = []
    for e in range(n_exp):
        d = str(root / f"exp{e}")
        order = rng.permutation(len(ids))
        probs = rng.rand(len(ids), 2, 101, 101).astype(np.float32)
        JaxExperiment(d).save_predictions("out_of_fold_train_predictions",
                                          [ids[k] for k in order], probs)
        dirs.append(d)
    return dirs


def test_join_and_align_jax_prediction_files(tmp_path):
    bundle_j = jax_synthetic_bundle(10, seed=2)
    dirs = _write_first_level(tmp_path, bundle_j)
    ids_j, cube_j = jax_stacking.join_experiment_predictions(dirs, "train")
    ids_p, cube_p = stacking.join_experiment_predictions(dirs, "train")
    assert ids_p == ids_j and cube_p.dtype == np.float32
    np.testing.assert_array_equal(cube_p, cube_j)
    sub_j, rows_j = jax_stacking.stacking_bundle(bundle_j.take(range(1, 9)),
                                                 ids_j, cube_j)
    bundle_p = synthetic_bundle(10, seed=2)
    sub_p, rows_p = stacking.stacking_bundle(bundle_p.take(range(1, 9)),
                                             ids_p, cube_p)
    assert sub_p.meta["id"].tolist() == sub_j.meta["id"].tolist()
    np.testing.assert_array_equal(rows_p, rows_j)
    np.testing.assert_array_equal(sub_p.masks, sub_j.masks)


@pytest.fixture(scope="module")
def pair():
    cfg = _config()
    jr = JaxRunner(cfg)
    pcfg = port_config(_config())
    runner = StackingRunner(pcfg, device="cpu")
    variables, flat = numpy_jax_variables(jr.model, seed=7, channels=M)
    cubes = _cubes(B, seed=8)
    masks = (cubes[..., 0] > 0.5).astype(np.uint8)
    return dict(jr=jr, runner=runner, variables=variables, flat=flat,
                cubes=cubes, masks=masks)


def test_runner_inputs_match_jax(pair):
    jr, runner = pair["jr"], pair["runner"]
    assert runner.config.execution.loader_mode == "stacking"
    jx, jy = jr._train_inputs(jnp.asarray(pair["cubes"]),
                              jnp.asarray(pair["masks"]),
                              jax.random.PRNGKey(0))
    px, py = runner._train_inputs(torch.from_numpy(pair["cubes"]),
                                  torch.from_numpy(pair["masks"]))
    assert px.shape == (B, M, 128, 128) and py.shape == (B, 128, 128, 2)
    np.testing.assert_allclose(px.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jx), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    ji = jr._infer_inputs(jnp.asarray(pair["cubes"]))
    pi = runner._infer_inputs(torch.from_numpy(pair["cubes"]))
    np.testing.assert_allclose(pi.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ji), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def step(pair):
    jr, runner, v = pair["jr"], pair["runner"], pair["variables"]
    jx, jy = jr._train_inputs(jnp.asarray(pair["cubes"]),
                              jnp.asarray(pair["masks"]),
                              jax.random.PRNGKey(0))

    def compute_loss(p):
        out, mutated = jr._apply(p, v["batch_stats"], jx, None, train=True,
                                 mutable=True)
        return jr.loss_fn(out, jy), mutated["batch_stats"]

    jloss, jstats = jax.jit(compute_loss)(v["params"])
    jx, jy = np.asarray(jx), np.asarray(jy)
    model = build_model(runner.config.model)
    load_flax_flat(model, pair["flat"])
    state = runner.train_state(model)
    g = torch.Generator().manual_seed(0)
    ploss = runner.train_step(state, torch.from_numpy(pair["cubes"]),
                              torch.from_numpy(pair["masks"]), g)
    x = torch.from_numpy(jx.copy()).permute(0, 3, 1, 2)
    jgrads, jparams, old = jax_float64_step(
        JaxStackingFCN(input_model_nr=M, dtype=jnp.float64), jr.tx,
        v["params"], v["batch_stats"], jx,
        lambda out: jr.loss_fn(out, jnp.asarray(jy)))
    pgrads, pparams = port_float64_step(runner, pair["flat"], x,
                                        torch.from_numpy(jy.copy()), LR)
    return dict(jloss=float(jloss), ploss=float(ploss), state=state,
                jstats=flatten_prefixed(jstats, "batch_stats"),
                pvars=to_flax_flat(state.model), jgrads=jgrads,
                jparams=jparams, old=old, pgrads=pgrads, pparams=pparams)


def test_train_step_matches_jax(step, pair):
    assert abs(step["ploss"] - step["jloss"]) <= 1e-5, (step["ploss"],
                                                        step["jloss"])
    assert step["state"].step == 1
    for k, want in step["jstats"].items():
        np.testing.assert_allclose(step["pvars"][k], want, rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert_step_matches(step["jgrads"], step["jparams"], step["old"],
                        step["pgrads"], step["pparams"], LR,
                        pair["runner"].config.training.l2_reg_conv,
                        max_free=0.02)


def test_predict_matches_jax_from_a_jax_checkpoint(pair, tmp_path):
    """A JAX-written ``best.npz`` restored by the port."""
    exp = JaxExperiment(str(tmp_path / "jax"))
    exp.save_params("stacking_network_fold_0", pair["variables"])
    exp.flush_saves()
    cubes = _cubes(5, seed=9)
    v = pair["variables"]
    want = pair["jr"].predict_dataset(
        SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"]),
        cubes)
    runner = pair["runner"]
    model = runner.restore(Experiment(str(tmp_path / "jax")).load_params(
        "stacking_network_fold_0"))
    got = runner.predict_dataset(model, cubes)
    assert got.shape == want.shape == (5, 2, 101, 101)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_stacking_cv_knobs_and_jax_reads_its_checkpoints(tmp_path):
    """``stacking_epochs`` 2 over ``--epochs`` 1 and ``stacking_lr``; the
    caller's config keeps its loader mode and architecture."""
    cfg = port_config(_config())
    cfg.model.architecture = "UNetResNet"
    cfg.training.epochs = 1
    cfg.training.stacking_epochs = 2
    cfg.training.stacking_lr = 1e-3
    bundle = synthetic_bundle(16, seed=5)
    cube = _cubes(16, seed=6)
    test_b = synthetic_bundle(8, seed=7, with_masks=False)
    exp = Experiment(str(tmp_path / "stack"))
    scores = stacking.train_evaluate_stacking(cfg, exp, bundle, cube,
                                              _cubes(8, seed=10), test_b,
                                              device="cpu")
    assert cfg.execution.loader_mode == "resize_and_pad"
    assert cfg.model.architecture == "UNetResNet"
    assert set(scores) == {"iou_mean", "iout_mean", "fold_iou", "fold_iout"}
    with open(tmp_path / "stack" / "stacking_cv_scores.json") as f:
        assert json.load(f) == scores
    for fold in range(2):
        with open(tmp_path / "stack" /
                  f"channels_stacking_network_fold_{fold}.jsonl") as f:
            epochs = {json.loads(line).get("epoch") for line in f}
        assert {0, 1} <= epochs and 2 not in epochs
    with open(tmp_path / "stack" / "config.json") as f:
        saved = json.load(f)
    assert saved["training"]["lr"] == 1e-3
    assert saved["model"]["architecture"] == "StackingFCN"
    assert saved["model"]["input_model_nr"] == M
    assert os.path.exists(tmp_path / "stack" / "stacking_submission.csv")

    # the JAX package reads the port's fold checkpoint
    jr = JaxRunner(_config())
    state = jr.init_state(0)
    like = {"params": state.params, "batch_stats": state.batch_stats}
    restored = JaxExperiment(str(tmp_path / "stack")).load_params(
        "stacking_network_fold_1", like)
    want = jr.predict_dataset(SimpleNamespace(**restored), cube[:4])
    runner = StackingRunner(port_config(_config()), device="cpu")
    got = runner.predict_dataset(runner.restore(
        exp.load_params("stacking_network_fold_1")), cube[:4])
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_stacking_cv_cli(tmp_path):
    cfg = default_config()
    train_b = jax_synthetic_bundle(16, seed=cfg.execution.seed)
    dirs = _write_first_level(tmp_path, train_b, n_exp=2)
    exp = tmp_path / "cli"
    assert cli.main(["stacking-cv", "--synthetic", "16", "--epochs", "1",
                     "--device", "cpu", "--stacking-experiments", *dirs,
                     "--set", f"paths.experiment_dir={exp}",
                     "--set", "training.dtype=float32",
                     "--set", "training.batch_size_train=4",
                     "--set", "training.batch_size_inference=4",
                     "--set", "execution.n_cv_splits=2"]) == 0
    with open(exp / "stacking_cv_scores.json") as f:
        assert len(json.load(f)["fold_iout"]) == 2
    # no test predictions in the first-level dirs: no stacking submission
    assert not (exp / "stacking_submission.csv").exists()
