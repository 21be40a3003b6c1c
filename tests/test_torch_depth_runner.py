"""The depth path of the runner against the JAX runner's, for the same
UNetResNetWithDepth-18 weights (numpy-seeded, fp32, batch 2):

- ``predict_dataset`` with depths, plain and hflip TTA, on 5 images (a
  ragged last batch padded with a zero image and a zero depth): fp32
  probabilities at atol 1e-3 (tests/test_torch_tta.py's tolerance), and
  the masks under the threshold-margin rule of
  tests/test_submission_parity.py:161-193;
- one train-mode forward and loss on the JAX runner's network inputs
  (1e-5, tests/test_torch_train_step.py's), through ``runner.update``.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from torch_parity import arch_configs, numpy_jax_variables, seeded_images

from salt_tpu.train.steps import SegmentationRunner as JaxRunner
from salt_tpu_torch.models.convert import load_flax_flat
from salt_tpu_torch.train.steps import SegmentationRunner

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

DEPTHS = np.array([0.1, 0.35, 0.6, 0.85, 0.5], np.float32)


@pytest.fixture(scope="module")
def runners():
    cfg, pcfg = arch_configs("UNetResNetWithDepth", 18)
    cfg.training.batch_size_inference = 2
    pcfg.training.batch_size_inference = 2
    jr = JaxRunner(cfg)
    variables, flat = numpy_jax_variables(jr.model, seed=6, depth=True)
    runner = SegmentationRunner(pcfg, device="cpu")
    model = runner.place(load_flax_flat(runner.build(), flat))
    return jr, variables, flat, runner, model


def _margin_rule(p_port, p_jax):
    """Masks ``> 0.5`` agree wherever JAX's probability clears the
    packages' delta (at most 5 pixels may not), and all of them when the
    smallest margin clears 10x the delta."""
    delta = float(np.abs(p_port - p_jax).max())
    assert delta < 1e-3, delta
    decidable = np.abs(p_jax - 0.5) > delta
    assert int((~decidable).sum()) <= 5
    np.testing.assert_array_equal((p_port > 0.5)[decidable],
                                  (p_jax > 0.5)[decidable])
    if float(np.abs(p_jax - 0.5).min()) > 10.0 * delta:
        np.testing.assert_array_equal(p_port > 0.5, p_jax > 0.5)


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_predict_dataset_with_depths_matches_jax(runners, tta):
    jr, variables, _, runner, model = runners
    imgs = seeded_images(5, seed=9)
    want = jr.predict_dataset(SimpleNamespace(**variables), imgs, DEPTHS,
                              batch_size=2, tta=tta)
    got = runner.predict_dataset(model, imgs, DEPTHS, batch_size=2, tta=tta)
    assert got.shape == (5, 2, 101, 101)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    _margin_rule(got[:, 1], want[:, 1])
    # the depths reach the probabilities
    other = runner.predict_dataset(model, imgs, DEPTHS[::-1].copy(),
                                   batch_size=2, tta=tta)
    assert np.abs(other - got).max() > 1e-2


def test_train_step_loss_matches_jax(runners):
    jr, variables, flat, runner, _ = runners
    images = seeded_images(2, seed=10)
    masks = (images > 140).astype(np.uint8)
    d = DEPTHS[:2].reshape(2, 1)
    aug_key, drop_key = jax.random.split(jax.random.PRNGKey(3))
    jx, jy = jr._train_inputs(images, masks, aug_key)

    def loss(params, stats):
        out, _ = jr._apply(params, stats, jx, d, train=True, rng=drop_key,
                           mutable=True)
        return jr.loss_fn(out, jy)

    jloss = float(jax.jit(loss)(variables["params"],
                                variables["batch_stats"]))
    state = runner.train_state(load_flax_flat(runner.build(), flat))
    x = torch.from_numpy(np.array(jx)).permute(0, 3, 1, 2)
    ploss = runner.update(state, x, torch.from_numpy(np.array(jy)),
                          depths=torch.from_numpy(d))
    assert abs(float(ploss) - jloss) <= 1e-5, (float(ploss), jloss)
