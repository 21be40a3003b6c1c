"""TTA and the inference steps: the port's ``predict_tta_step`` /
``predict_step`` / ``predict_dataset`` vs the JAX runner's on the same
weights and uint8 images, [B, 2, 101, 101] fp32 probabilities at
atol=1e-3 (the logits agree to ~1e-6 on this host; 1e-3 bounds the
probabilities after both packages' sigmoid, flip and mean with room for
other hosts' convolution order)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_parity import (flagship_config, port_config, seeded_images,
                          seeded_jax_variables)

from salt_tpu.models.registry import build_model as jax_build_model
from salt_tpu.ops import tta as jax_tta
from salt_tpu.train.steps import SegmentationRunner as JaxRunner
from salt_tpu_torch.models.convert import load_flax_flat
from salt_tpu_torch.models.registry import build_model
from salt_tpu_torch.ops import tta
from salt_tpu_torch.train.steps import SegmentationRunner

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runners():
    cfg = flagship_config(18)
    cfg.training.batch_size_inference = 2
    variables, flat = seeded_jax_variables(
        jax_build_model(cfg.model, "float32"), seed=5)
    jax_runner = JaxRunner(cfg)
    runner = SegmentationRunner(port_config(cfg), device="cpu")
    model = runner.place(load_flax_flat(build_model(runner.config.model),
                                         flat))
    return jax_runner, variables, runner, model


def test_tta_step_matches_jax(runners):
    jax_runner, variables, runner, model = runners
    imgs = seeded_images(2, seed=7)
    want = np.asarray(jax_runner.predict_tta_step(
        variables["params"], variables["batch_stats"], imgs, None))
    got = runner.predict_tta_step(model, torch.from_numpy(imgs))
    assert got.shape == (2, 2, 101, 101) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_predict_dataset_ragged_matches_jax(runners):
    """5 images at batch 2: the last batch is padded with a zero image and
    the padding dropped; no-TTA path."""
    jax_runner, variables, runner, model = runners
    imgs = seeded_images(5, seed=8)
    state = SimpleNamespace(**variables)
    want = jax_runner.predict_dataset(state, imgs, batch_size=2)
    got = runner.predict_dataset(model, imgs, batch_size=2)
    assert got.shape == (5, 2, 101, 101)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_flip_before_pad():
    """TTA flips the uint8 101-wide image BEFORE the asymmetric pad:
    the flipped branch equals flipping the 101-wide input, which differs
    from flipping the padded 128-wide input by one column."""
    spec = tta.build_tta_specs()[1]
    assert spec["lr_flip"] and not spec["ud_flip"]
    x = torch.arange(101.0).expand(1, 101, 101)
    from salt_tpu_torch.ops.preprocess import pad_to_divisor
    right = pad_to_divisor(tta.tta_transform(x, spec), 64, "edge")
    wrong = tta.tta_transform(pad_to_divisor(x, 64, "edge"), spec)
    assert not torch.equal(right, wrong)
    assert torch.equal(right[..., 1:], wrong[..., :-1])


@pytest.mark.parametrize("flip_ud,rotation", [(False, False), (True, True)])
def test_specs_and_transforms_match_jax(flip_ud, rotation):
    specs = tta.build_tta_specs(flip_ud, True, rotation, 0)
    assert specs == jax_tta.build_tta_specs(flip_ud, True, rotation, 0)
    assert specs[0] == {"ud_flip": False, "lr_flip": False, "rotation": 0,
                        "color_shift": False}
    x = np.random.RandomState(0).rand(2, 2, 6, 6).astype(np.float32)
    for s in specs:
        fwd = tta.tta_transform(torch.from_numpy(x), s).numpy()
        np.testing.assert_array_equal(fwd, np.asarray(jax_tta.tta_transform(x, s)))
        inv = tta.tta_inverse_transform(torch.from_numpy(fwd), s).numpy()
        np.testing.assert_array_equal(inv, x)


@pytest.mark.parametrize("method", ["mean", "max", "min", "gmean"])
def test_aggregate_matches_jax(method):
    x = np.random.RandomState(1).rand(3, 2, 5, 5).astype(np.float32)
    got = tta.aggregate(torch.from_numpy(x), method).numpy()
    want = np.asarray(jax_tta.aggregate(x, method))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
