"""Resuming, in the port, a ``last.npz`` that the JAX package wrote, and
the validation image monitor against the JAX package's; CPU, a SaltUNet
of 4 filters and 2 levels, fp32.

JAX makes one optax update (its ``make_optimizer``, by a seeded
gradient) of a numpy-seeded SaltUNet and saves the state with
``Experiment.save_params(..., tag="last")``, as its ``ModelCheckpoint``
does, with the L2 term in the optax chain and without it (the Adam
state's chain index moves). The port's
``load_last`` must give Adam moments equal to JAX's ``mu`` / ``nu``
(rtol 1e-6; they are copies through the weight bridge), JAX's step and
learning rate; then one more update of each from one seeded gradient
must agree at rtol=atol=1e-5 (parameters and moments). ``cli train
--resume`` then continues JAX's experiment from its next epoch at its
learning rate and writes the monitor's PNGs.

The monitor's triptych PNG from one shared checkpoint: the input and
target columns pixel-equal to JAX's, the prediction column (probability
x 255, truncated) pixel-equal wherever JAX's value is farther from an
integer than 255 x the probability delta of the two packages, the
margin rule of tests/test_submission_parity.py:161-193 applied to the
truncation, with at most 5 such pixels."""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import optax

from torch_parity import (flatten, numpy_jax_variables, port_config,
                          unflatten_like)

from salt_tpu.core.config import default_config as jax_default_config
from salt_tpu.core.experiment import Experiment as JaxExperiment
from salt_tpu.train.steps import SegmentationRunner as JaxRunner
from salt_tpu_torch.core.experiment import Experiment
from salt_tpu_torch.models.convert import from_flax_flat, to_flax_flat
from salt_tpu_torch.pipeline import api
from salt_tpu_torch.train.steps import SegmentationRunner

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

LR = 3e-3
TOL = dict(rtol=1e-5, atol=1e-5)


def tiny_config(l2):
    cfg = jax_default_config()
    cfg.model.architecture = "SaltUNet"
    cfg.model.n_filters = 4
    cfg.model.repeat_blocks = 2
    cfg.training.dtype = "float32"
    cfg.training.lr = LR
    cfg.training.l2_reg_conv = l2
    cfg.training.batch_size_train = 2
    cfg.training.batch_size_inference = 4
    cfg.execution.n_cv_splits = 4
    cfg.parallel.n_devices = 1
    return cfg


def _port_flat(model, tensors):
    """Per-parameter tensors under the flat flax ``params/...`` keys."""
    import copy
    clone = copy.deepcopy(model).float()
    with torch.no_grad():
        for p, t in zip(clone.parameters(), tensors):
            p.copy_(t)
    return {k: v for k, v in to_flax_flat(clone).items()
            if k.startswith("params/")}


def _adam(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")][0]


@pytest.fixture(scope="module", params=[0.0, 1e-4], ids=["no_l2", "l2"])
def jax_last(request, tmp_path_factory):
    """A JAX experiment dir after one optax update of a numpy-seeded
    SaltUNet by a seeded gradient, its ``last.npz`` (and ``best.npz``),
    the optimizer and the state."""
    from salt_tpu.models.registry import build_model as jax_build_model
    from salt_tpu.train.state import make_optimizer
    cfg = tiny_config(request.param)
    tx = make_optimizer(LR, cfg.training.l2_reg_conv)
    variables, _ = numpy_jax_variables(
        jax_build_model(cfg.model, "float32"), seed=1)
    params = variables["params"]
    rng = np.random.RandomState(2)
    grads = jax.tree.map(
        lambda p: (1e-2 * rng.randn(*p.shape)).astype(np.float32), params)
    updates, opt_state = tx.update(grads, tx.init(params), params)
    state = SimpleNamespace(params=optax.apply_updates(params, updates),
                            batch_stats=variables["batch_stats"],
                            opt_state=opt_state, step=np.int32(1))
    root = str(tmp_path_factory.mktemp("jax_last") / "exp")
    exp = JaxExperiment(root)
    exp.save_params("network", {"params": state.params,
                                "batch_stats": state.batch_stats,
                                "opt_state": state.opt_state,
                                "step": state.step}, tag="last",
                    meta={"epoch": 0, "finished": False,
                          "early_stopped": False})
    exp.save_params("network", {"params": state.params,
                                "batch_stats": state.batch_stats},
                    meta={"epoch": 0, "iout": 0.0})
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f)
    return dict(cfg=cfg, tx=tx, state=state, root=root)


def test_load_last_maps_the_optax_adam_state(jax_last):
    cfg, jstate = jax_last["cfg"], jax_last["state"]
    runner = SegmentationRunner(port_config(cfg), device="cpu")
    state, next_epoch = api.load_last(runner, Experiment(jax_last["root"]),
                                      "network")
    assert next_epoch == 1 and state.step == 1
    assert state.learning_rate == pytest.approx(LR, rel=1e-7)
    assert state.optimizer.param_groups[0]["weight_decay"] == \
        cfg.training.l2_reg_conv
    adam = _adam(jstate.opt_state)
    params = list(state.model.parameters())
    opt = [state.optimizer.state[p] for p in params]
    assert all(int(s["step"]) == int(adam.count) == 1 for s in opt)
    for leaf, kind in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        want = flatten({"params": jax.device_get(getattr(adam, leaf))})
        got = _port_flat(state.model, [s[kind] for s in opt])
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=0,
                                       err_msg=k)
    got = to_flax_flat(state.model)
    for k, v in flatten({"params": jax.device_get(jstate.params)}).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_one_more_step_agrees_with_jax(jax_last):
    """The same seeded gradient through each package's optimizer from the
    resumed state: optax's ``tx.update`` and the port's ``Adam.step``."""
    cfg, tx, jstate = jax_last["cfg"], jax_last["tx"], jax_last["state"]
    flat_params = flatten({"params": jax.device_get(jstate.params)})
    rng = np.random.RandomState(3)
    grads = {k: (1e-2 * rng.randn(*v.shape)).astype(np.float32)
             for k, v in flat_params.items()}
    g_tree = unflatten_like(grads, {"params": jstate.params})["params"]
    updates, opt_state = tx.update(g_tree, jstate.opt_state, jstate.params)
    new_params = optax.apply_updates(jstate.params, updates)

    runner = SegmentationRunner(port_config(cfg), device="cpu")
    state, _ = api.load_last(runner, Experiment(jax_last["root"]), "network")
    sd = from_flax_flat(grads)
    for name, p in state.model.named_parameters():
        p.grad = sd[name].to(p.dtype).contiguous(
            memory_format=torch.channels_last) if p.dim() == 4 else sd[name]
    state.optimizer.step()
    got = to_flax_flat(state.model)
    for k, v in flatten({"params": jax.device_get(new_params)}).items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)
    adam = _adam(opt_state)
    opt = [state.optimizer.state[p] for p in state.model.parameters()]
    for leaf, kind in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        want = flatten({"params": jax.device_get(getattr(adam, leaf))})
        got_m = _port_flat(state.model, [s[kind] for s in opt])
        for k, v in want.items():
            np.testing.assert_allclose(got_m[k], v, err_msg=k, **TOL)


def test_cli_resumes_the_jax_experiment(jax_last, tmp_path):
    """``train --resume`` on the JAX-written experiment (its copy): epoch
    1 only, at JAX's injected learning rate, the monitor's PNG for it."""
    import shutil
    from salt_tpu_torch import cli
    exp = str(tmp_path / "exp")
    shutil.copytree(jax_last["root"], exp)
    cfg = jax_last["cfg"]
    with open(os.path.join(exp, "channels_network.jsonl"), "w"):
        pass
    rc = cli.main(["train", "--resume", "--epochs", "2", "--synthetic", "16",
                   "--device", "cpu", "--set", f"paths.experiment_dir={exp}",
                   "--set", "model.architecture=SaltUNet",
                   "--set", "model.n_filters=4",
                   "--set", "model.repeat_blocks=2",
                   "--set", "training.dtype=float32",
                   "--set", "training.lr=0.1",
                   "--set", f"training.l2_reg_conv={cfg.training.l2_reg_conv}",
                   "--set", "training.batch_size_train=4",
                   "--set", "training.batch_size_inference=4",
                   "--set", "training.validation_images_every=1",
                   "--set", "training.validation_image_nr=3",
                   "--set", "execution.n_cv_splits=4"])
    assert rc == 0
    with open(os.path.join(exp, "channels_network.jsonl")) as f:
        epochs = [json.loads(line) for line in f]
    assert [e["epoch"] for e in epochs] == [1]
    assert epochs[0]["lr"] == pytest.approx(LR, rel=1e-7)
    png = os.path.join(exp, "validation_images_network",
                       "validation_epoch_0001.png")
    from PIL import Image
    assert np.asarray(Image.open(png)).shape == (3 * 101, 3 * 101)
    with open(os.path.join(exp, "checkpoints", "network", "last.json")) as f:
        assert json.load(f)["epoch"] == 1


def test_validation_image_monitor_png_matches_jax(tmp_path):
    from PIL import Image

    from salt_tpu.data.bundle import synthetic_bundle
    from salt_tpu.models.registry import build_model as jax_build_model
    from salt_tpu.train.callbacks import \
        ValidationImageMonitor as JaxMonitor
    from salt_tpu_torch.train.callbacks import ValidationImageMonitor
    cfg = tiny_config(0.0)
    variables, flat = numpy_jax_variables(
        jax_build_model(cfg.model, "float32"), seed=13)
    bundle = synthetic_bundle(6, seed=4)
    jr = JaxRunner(cfg)
    JaxMonitor(str(tmp_path / "jax"), jr, bundle.images, bundle.masks,
               image_nr=5, image_every=2).on_epoch_end(
        {"epoch_id": 4, "state": SimpleNamespace(**variables)})
    runner = SegmentationRunner(port_config(cfg), device="cpu")
    model = runner.restore(flat)
    model.train()                      # the monitor predicts in eval mode
    ValidationImageMonitor(str(tmp_path / "port"), runner, bundle.images,
                           bundle.masks, image_nr=5, image_every=2
                           ).on_epoch_end({"epoch_id": 4,
                                           "state": SimpleNamespace(
                                               model=model)})
    ValidationImageMonitor(str(tmp_path / "skip"), runner, bundle.images,
                           bundle.masks, image_every=2).on_epoch_end(
        {"epoch_id": 3, "state": SimpleNamespace(model=model)})
    assert not os.listdir(tmp_path / "skip")
    name = "validation_epoch_0004.png"
    want = np.asarray(Image.open(tmp_path / "jax" / name))
    got = np.asarray(Image.open(tmp_path / "port" / name))
    assert got.shape == want.shape == (5 * 101, 3 * 101)
    for col in (0, 2):                  # the input and the target
        np.testing.assert_array_equal(got[:, col * 101:(col + 1) * 101],
                                      want[:, col * 101:(col + 1) * 101])
    p_jax = jr.predict_dataset(SimpleNamespace(**variables),
                               bundle.images[:5])[:, 1]
    p_port = runner.predict_dataset(model, bundle.images[:5])[:, 1]
    delta = float(np.abs(p_port - p_jax).max())
    assert delta < 1e-4
    scaled = (p_jax * 255).reshape(5 * 101, 101)
    decidable = np.abs(scaled - np.round(scaled)) > 255 * delta
    pred_got, pred_want = got[:, 101:202], want[:, 101:202]
    assert int((~decidable).sum()) <= 5
    np.testing.assert_array_equal(pred_got[decidable], pred_want[decidable])
