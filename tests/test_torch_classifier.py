"""The port's ``ClassifierRunner`` against the JAX package's on the CPU
(EmptinessClassifier, ResNet-18 trunk, fp32, batch 2, the same seeded
weights and images).

- The inference input (pad 101 -> 128) matches JAX's ``_prep_infer`` to
  1e-6; the train input (the image policy with the draws JAX makes from
  a key, resize 102, pad 13) JAX's ``_prep_train`` to 2.5e-4, the
  augmentation policy's 5e-5 (tests/test_torch_augment.py) over the
  normalization's 0.229, as tests/test_torch_train_step.py holds the
  segmentation input.
- ``predict_dataset``'s probabilities match within rtol = atol = 2e-3
  (the whole-model tolerance, tests/test_flagship_golden.py:220).
- One train step from the same weights on JAX's inputs: in fp32 the loss
  and the new BatchNorm statistics (1e-5); gradients and the Adam step
  in float64 on both sides, by the rules of
  tests/test_torch_train_step.py (the trunk's last stage is 8x8 at batch
  2, where flax's one-pass BN variance makes fp32 gradients noisy). A
  two-logit head over two images leaves more of each leaf's gradient
  near zero than the U-Net's: 1.2% of the elements are within the
  sign rule's band (the U-Net: under 1%), so the bound is 2%.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import numpy_jax_variables, port_config, seeded_images
from torch_train_parity import (assert_step_matches, flatten_prefixed,
                                jax_augment_params, jax_float64_step,
                                port_float64_step)

from salt_tpu.core.config import default_config
from salt_tpu.models.emptiness import EmptinessClassifier as JaxClassifier
from salt_tpu.train.classifier import ClassifierRunner as JaxRunner
from salt_tpu_torch.models.convert import load_flax_flat, to_flax_flat
from salt_tpu_torch.models.registry import build_model
from salt_tpu_torch.train.classifier import ClassifierRunner

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

B = 2
LR = 1e-4


def _config():
    cfg = default_config()
    cfg.model.architecture = "EmptinessClassifier"
    cfg.training.dtype = "float32"
    cfg.training.lr = LR
    cfg.training.batch_size_inference = 2
    return cfg


@pytest.fixture(scope="module")
def pair():
    cfg = _config()
    jr = JaxRunner(cfg)
    variables, flat = numpy_jax_variables(jr.model, seed=5)
    runner = ClassifierRunner(port_config(cfg), device="cpu")
    return dict(jr=jr, runner=runner, variables=variables, flat=flat,
                images=seeded_images(5, seed=6))


def test_infer_inputs_match_jax(pair):
    images = pair["images"]
    want = np.asarray(pair["jr"]._prep_infer(jnp.asarray(images)))
    got = pair["runner"]._prep_infer(torch.from_numpy(images))
    assert got.shape == (5, 3, 128, 128)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-6)


def test_train_inputs_match_jax(pair):
    images = pair["images"][:B]
    key = jax.random.PRNGKey(21)
    want = np.asarray(pair["jr"]._prep_train(jnp.asarray(images), key))
    got = pair["runner"]._prep_train(torch.from_numpy(images),
                                     jax_augment_params(key, B, 101, 101))
    assert got.shape == (B, 3, 128, 128)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=2.5e-4)


def test_predict_dataset_matches_jax(pair):
    """Five images at batch 2: the last batch padded."""
    v = pair["variables"]
    want = pair["jr"].predict_dataset(
        SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"]),
        pair["images"])
    runner = pair["runner"]
    got = runner.predict_dataset(runner.restore(pair["flat"]), pair["images"])
    assert got.shape == want.shape == (5, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def step(pair):
    jr, runner, v = pair["jr"], pair["runner"], pair["variables"]
    images = pair["images"][:B]
    labels = np.array([1.0, 0.0], np.float32)
    jx = np.asarray(jr._prep_train(jnp.asarray(images),
                                   jax.random.PRNGKey(8)))
    y = np.stack([1.0 - labels, labels], axis=-1)

    def loss(out):
        return jr.loss_fn(out[:, None, None, :], jnp.asarray(y)[:, None, None, :])

    def compute_loss(p):
        out, mutated = jr.model.apply(
            {"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(jx),
            train=True, mutable=["batch_stats"])
        return loss(out), mutated["batch_stats"]

    jloss, jstats = jax.jit(compute_loss)(v["params"])
    model = build_model(runner.config.model)
    load_flax_flat(model, pair["flat"])
    state = runner.train_state(model)
    x = torch.from_numpy(jx.copy()).permute(0, 3, 1, 2)
    ploss = runner.update(state, x, torch.from_numpy(y))

    jgrads, jparams, old = jax_float64_step(
        JaxClassifier(encoder_depth=18, dtype=jnp.float64), jr.tx,
        v["params"], v["batch_stats"], jx, loss)
    pgrads, pparams = port_float64_step(runner, pair["flat"], x,
                                        torch.from_numpy(y), LR)
    return dict(jloss=float(jloss), ploss=float(ploss),
                jstats=flatten_prefixed(jstats, "batch_stats"),
                pvars=to_flax_flat(state.model), jgrads=jgrads,
                jparams=jparams, old=old, pgrads=pgrads, pparams=pparams,
                state=state)


def test_train_step_loss_and_batch_stats_match_jax(step):
    assert abs(step["ploss"] - step["jloss"]) <= 1e-5, (step["ploss"],
                                                        step["jloss"])
    assert step["state"].step == 1
    for k, want in step["jstats"].items():
        np.testing.assert_allclose(step["pvars"][k], want, rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_train_step_gradients_and_update_match_jax_in_float64(step, pair):
    assert_step_matches(step["jgrads"], step["jparams"], step["old"],
                        step["pgrads"], step["pparams"], LR,
                        pair["runner"].config.training.l2_reg_conv,
                        max_free=0.02)


def test_fit_classifier_runs_and_scores_auc(pair):
    """Two epochs of the loop: the ragged tail dropped (5 images at batch
    2: 2 steps an epoch), AUC scored every epoch."""
    from salt_tpu_torch.train.classifier import fit_classifier
    runner = pair["runner"]
    runner.config.training.batch_size_train = 2
    images = pair["images"]
    labels = np.array([1, 0, 1, 1, 0], np.float32)
    state, hist = fit_classifier(runner, (images, labels),
                                 (images, labels), epochs=2, seed=3)
    assert state.step == 4 and len(hist) == 2
    assert all(np.isfinite(h["train_loss"]) and 0 <= h["val_auc"] <= 1
               for h in hist)
