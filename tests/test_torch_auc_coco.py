"""The port's ``metrics/auc.py`` and ``ops/coco_rle.py`` against the JAX
package's on seeded inputs: equal results (both are numpy; the AUC's
midranks make ties exact)."""
import numpy as np
import pytest
import torch

from salt_tpu.metrics.auc import roc_auc as jax_roc_auc
from salt_tpu.ops import coco_rle as jax_coco
from salt_tpu_torch.metrics.auc import roc_auc
from salt_tpu_torch.ops import coco_rle

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roc_auc_equals_jax_with_ties(seed):
    rng = np.random.RandomState(seed)
    y = (rng.rand(200) > 0.4).astype(np.int64)
    s = np.round(rng.rand(200), 1)          # 11 levels: many ties
    assert roc_auc(y, s) == jax_roc_auc(y, s)
    s32 = rng.rand(200).astype(np.float32)
    assert roc_auc(y.astype(bool), s32) == jax_roc_auc(y.astype(bool), s32)


def test_roc_auc_needs_both_classes():
    for fn in (roc_auc, jax_roc_auc):
        with pytest.raises(ValueError, match="both classes"):
            fn(np.ones(4), np.linspace(0, 1, 4))


def _masks(seed):
    rng = np.random.RandomState(seed)
    field = rng.rand(13, 13)
    blobs = np.kron(field, np.ones((8, 8)))[:101, :101] > 0.7
    return [blobs, np.zeros((101, 101), bool), np.ones((101, 101), bool),
            rng.rand(7, 5) > 0.5, np.zeros((0, 0), bool)]


@pytest.mark.parametrize("seed", [0, 3])
def test_coco_rle_functions_equal_jax(seed):
    masks = _masks(seed)
    for m in masks:
        rle = coco_rle.rle_from_binary(m)
        assert rle == jax_coco.rle_from_binary(m)
        if m.size:
            np.testing.assert_array_equal(coco_rle.binary_from_rle(rle),
                                          jax_coco.binary_from_rle(rle))
            np.testing.assert_array_equal(coco_rle.binary_from_rle(rle),
                                          m.astype(np.uint8))
    labeled = coco_rle.label_components(masks[0])
    np.testing.assert_array_equal(labeled,
                                  jax_coco.label_components(masks[0]))
    assert labeled.max() > 1                  # several blobs
    segs = coco_rle.get_segmentations(labeled)
    assert segs == jax_coco.get_segmentations(labeled)
    other = coco_rle.get_segmentations(
        coco_rle.label_components(_masks(seed + 1)[0]))
    np.testing.assert_array_equal(coco_rle.iou_matrix(segs, other),
                                  jax_coco.iou_matrix(segs, other))
    assert coco_rle.iou_matrix([], other).shape == (0, 0)
