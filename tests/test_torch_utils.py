"""``salt_tpu_torch/utils.py`` (the port's own copy of
``salt_tpu/utils.py``) against the JAX package's helpers, on the inputs
``tests/test_utils_pipeline.py`` exercises them with: the same values
bit for bit, and ``set_seed`` seeding ``random``, numpy and torch."""
import random

import numpy as np
import pytest
import torch

from salt_tpu import utils as ref
from salt_tpu_torch import utils

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


@pytest.mark.parametrize("x", [np.array([0.0]), np.array([-3.0, 0.5, 40.0]),
                               np.random.RandomState(1).randn(4, 3)])
def test_sigmoid_equals_jax_packages(x):
    np.testing.assert_array_equal(utils.sigmoid(x), ref.sigmoid(x))


@pytest.mark.parametrize("x,kw", [
    (np.array([1.0, 2.0, 3.0]), {}),
    (np.random.RandomState(0).rand(3, 5), {"axis": 1}),
    (np.random.RandomState(2).rand(1, 4), {"theta": 2.5}),
    (np.random.RandomState(3).rand(2, 3, 4), {"axis": 0})])
def test_softmax_equals_jax_packages(x, kw):
    got, want = utils.softmax(x, **kw), ref.softmax(x, **kw)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_pil_roundtrip_equals_jax_packages():
    img = (np.random.RandomState(0).rand(16, 16) * 255).astype(np.uint8)
    back = utils.from_pil(utils.to_pil(img))
    np.testing.assert_array_equal(back, ref.from_pil(ref.to_pil(img)))
    np.testing.assert_array_equal(back, img)
    a, b = utils.from_pil(*utils.to_pil(img, img))
    np.testing.assert_array_equal(a, b)


def test_get_list_of_image_predictions_equals_jax_packages():
    batches = [np.zeros((4, 2, 2)), np.ones((3, 2, 2))]
    got = utils.get_list_of_image_predictions(batches)
    want = ref.get_list_of_image_predictions(batches)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_set_seed_seeds_random_numpy_and_torch():
    utils.set_seed(7)
    first = (random.random(), np.random.rand(), torch.rand(1).item())
    ref.set_seed(7)
    assert (random.random(), np.random.rand()) == first[:2]
    utils.set_seed(7)
    assert (random.random(), np.random.rand(), torch.rand(1).item()) == first


def test_plot_list_saves_a_figure(tmp_path):
    img = np.random.RandomState(0).rand(8, 8)
    path = str(tmp_path / "plot.png")
    fig = utils.plot_list([img, img], [img > 0.5], save_to=path)
    assert len(fig.axes) == 3
    from PIL import Image
    assert Image.open(path).size[0] > 0
