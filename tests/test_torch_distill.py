"""The port's distillation against the JAX package's on the CPU
(student SaltUNet, 8 filters, fp32, batch 2).

- ``pack_targets`` equals JAX's, and the pack crossing to the device as
  int16 bits unpacks to JAX's hard and soft targets exactly.
- ``_distill_inputs`` with the draws JAX makes from a key: the network
  input within 2.5e-4 (the augmentation policy's 5e-5 over the
  normalization's 0.229, tests/test_torch_train_step.py), the soft
  target within 1e-4, the hard target flipping on at most 0.05% of the
  pixels (where the warped mask sits within the tolerance of 0.5).
- One step on JAX's inputs from the same weights: the distill loss
  (alpha BCE(soft) + (1 - alpha) Lovász(hard)) and the new BatchNorm
  statistics in fp32 (1e-5), gradients and the Adam step in float64 by
  the rules of tests/test_torch_train_step.py.
- ``distill --teacher`` on a teacher the JAX package wrote, at a tiny
  size with ``--device cpu``, writes ``distill_report.json`` with the
  keys of JAX's (``salt_tpu/pipeline/distill.py:109-124``).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import numpy_jax_variables, port_config, seeded_images
from torch_train_parity import (assert_step_matches, flatten_prefixed,
                                jax_augment_params, jax_float64_step,
                                port_float64_step)

from salt_tpu.core.config import default_config
from salt_tpu.core.experiment import Experiment as JaxExperiment
from salt_tpu.data.bundle import synthetic_bundle as jax_synthetic_bundle
from salt_tpu.models.salt_unet import SaltUNet as JaxSaltUNet
from salt_tpu.train.distill import DistillRunner as JaxRunner
from salt_tpu.train.distill import pack_targets as jax_pack_targets
from salt_tpu_torch import cli
from salt_tpu_torch.models.convert import load_flax_flat, to_flax_flat
from salt_tpu_torch.models.registry import build_model
from salt_tpu_torch.train.distill import (DistillRunner, pack_targets,
                                          unpack_targets)

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

B = 2
LR = 1e-4
ALPHA = 0.75
REPORT_KEYS = {"student_architecture", "distill_alpha", "teacher_dir",
               "n_train", "n_valid", "student_iou", "student_iout",
               "teacher_iou", "teacher_iout", "iout_delta"}


def _config():
    cfg = default_config()
    cfg.model.architecture = "SaltUNet"
    cfg.model.n_filters = 8
    cfg.training.dtype = "float32"
    cfg.training.lr = LR
    cfg.training.distill_alpha = ALPHA
    return cfg


def _targets(n, seed):
    images = seeded_images(n, seed=seed)
    masks = (images > 140).astype(np.uint8)
    probs = np.clip(images / 255.0 + 0.05 * np.random.RandomState(seed)
                    .randn(n, 101, 101), -0.1, 1.1).astype(np.float32)
    return images, masks, probs


def test_pack_and_unpack_equal_jax():
    _, masks, probs = _targets(3, seed=1)
    packed = pack_targets(masks, probs)
    np.testing.assert_array_equal(packed, jax_pack_targets(masks, probs))
    assert packed.dtype == np.uint16
    runner = DistillRunner(port_config(_config()), device="cpu")
    dev, = runner.device_batch(packed)
    assert dev.dtype == torch.int16
    hard, soft = unpack_targets(dev)
    p = jnp.asarray(packed)
    np.testing.assert_array_equal(
        hard.numpy(), np.asarray(((p >> 8) & 0x1).astype(jnp.float32)))
    np.testing.assert_array_equal(
        soft.numpy(), np.asarray((p & 0xFF).astype(jnp.float32) / 255.0))


@pytest.fixture(scope="module")
def pair():
    cfg = _config()
    jr = JaxRunner(cfg)
    variables, flat = numpy_jax_variables(jr.model, seed=11)
    runner = DistillRunner(port_config(cfg), device="cpu")
    images, masks, probs = _targets(B, seed=2)
    return dict(jr=jr, runner=runner, variables=variables, flat=flat,
                images=images, packed=pack_targets(masks, probs))


def test_distill_inputs_match_jax(pair):
    key = jax.random.PRNGKey(4)
    jx, jsoft, jhard = pair["jr"]._distill_inputs(
        jnp.asarray(pair["images"]), jnp.asarray(pair["packed"]), key)
    packed, = pair["runner"].device_batch(pair["packed"])
    px, psoft, phard = pair["runner"]._distill_inputs(
        torch.from_numpy(pair["images"]), packed,
        jax_augment_params(key, B, 101, 101))
    assert px.shape == (B, 3, 128, 128)
    assert psoft.shape == phard.shape == (B, 128, 128, 2)
    np.testing.assert_allclose(px.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jx), rtol=0, atol=2.5e-4)
    np.testing.assert_allclose(psoft.numpy(), np.asarray(jsoft), rtol=0,
                               atol=1e-4)
    assert (phard.numpy() != np.asarray(jhard)).mean() <= 5e-4


@pytest.fixture(scope="module")
def step(pair):
    jr, runner, v = pair["jr"], pair["runner"], pair["variables"]
    jx, jsoft, jhard = jr._distill_inputs(
        jnp.asarray(pair["images"]), jnp.asarray(pair["packed"]),
        jax.random.PRNGKey(5))

    def loss(out):
        soft = optax.sigmoid_binary_cross_entropy(
            out.astype(jnp.float32), jsoft).mean()
        return ALPHA * soft + (1.0 - ALPHA) * jr.loss_fn(out, jhard)

    def compute_loss(p):
        out, mutated = jr._apply(p, v["batch_stats"], jx, None, train=True,
                                 mutable=True)
        return loss(out), mutated["batch_stats"]

    jloss, jstats = jax.jit(compute_loss)(v["params"])
    jx, ys, yh = (np.array(a) for a in (jx, jsoft, jhard))
    model = build_model(runner.config.model)
    load_flax_flat(model, pair["flat"])
    state = runner.train_state(model)
    x = torch.from_numpy(jx).permute(0, 3, 1, 2)
    y = (torch.from_numpy(ys), torch.from_numpy(yh))
    ploss = runner.update(state, x, y)
    jgrads, jparams, old = jax_float64_step(
        JaxSaltUNet(n_filters=8, dtype=jnp.float64), jr.tx, v["params"],
        v["batch_stats"], jx, loss)
    pgrads, pparams = port_float64_step(runner, pair["flat"], x, y, LR)
    return dict(jloss=float(jloss), ploss=float(ploss), state=state,
                jstats=flatten_prefixed(jstats, "batch_stats"),
                pvars=to_flax_flat(state.model), jgrads=jgrads,
                jparams=jparams, old=old, pgrads=pgrads, pparams=pparams)


def test_distill_step_matches_jax(step, pair):
    assert abs(step["ploss"] - step["jloss"]) <= 1e-5, (step["ploss"],
                                                        step["jloss"])
    for k, want in step["jstats"].items():
        np.testing.assert_allclose(step["pvars"][k], want, rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert_step_matches(step["jgrads"], step["jparams"], step["old"],
                        step["pgrads"], step["pparams"], LR,
                        pair["runner"].config.training.l2_reg_conv)


def test_train_step_runs_on_the_packed_batch(pair):
    runner = pair["runner"]
    model = build_model(runner.config.model)
    load_flax_flat(model, pair["flat"])
    state = runner.train_state(model)
    img, packed = runner.device_batch(pair["images"], pair["packed"])
    loss = runner.train_step(state, img, packed,
                             torch.Generator().manual_seed(0))
    assert torch.isfinite(loss) and state.step == 1


def test_distill_cli_writes_the_report(tmp_path):
    seed = default_config().execution.seed
    train = jax_synthetic_bundle(16, seed=seed)
    rng = np.random.RandomState(3)
    teacher = str(tmp_path / "teacher")
    JaxExperiment(teacher).save_predictions(
        "out_of_fold_train_predictions", train.meta["id"].tolist(),
        rng.rand(16, 2, 101, 101).astype(np.float32))
    student = tmp_path / "student"
    assert cli.main(["distill", "--teacher", teacher, "--synthetic", "16",
                     "--epochs", "1", "--device", "cpu",
                     "--distill-alpha", "0.6", "--measure-throughput",
                     "--set", f"paths.experiment_dir={student}",
                     "--set", "model.architecture=SaltUNet",
                     "--set", "model.n_filters=8",
                     "--set", "training.dtype=float32",
                     "--set", "training.batch_size_train=4",
                     "--set", "training.batch_size_inference=4",
                     "--set", "execution.n_cv_splits=4"]) == 0
    with open(student / "distill_report.json") as f:
        report = json.load(f)
    assert set(report) == REPORT_KEYS | {"student_tta_images_per_sec"}
    assert report["distill_alpha"] == pytest.approx(0.6)
    assert report["n_train"] == 12 and report["n_valid"] == 4
    assert report["student_tta_images_per_sec"] > 0
    assert (student / "checkpoints" / "network" / "best.npz").exists()
    with pytest.raises(SystemExit, match="--teacher"):
        cli.main(["distill", "--synthetic", "8", "--device", "cpu",
                  "--set", f"paths.experiment_dir={tmp_path / 'x'}"])
