"""Data parallelism of the port over ``torch.distributed``
(``salt_tpu_torch/parallel/mesh.py``) on the CPU: a 2-process gloo
group against one process, as the JAX package's
``tests/test_mesh_equivalence.py`` (:50-100) holds its 1- and 8-device
meshes: three data-parallel train steps of a batch of 16 (SaltUNet, 8
filters, 2 levels, fp32, Lovász; here with channel dropout 0.3, its
draws made for the whole batch and sliced) equal three one-process
steps on the whole batch, losses at rtol 1e-4 and atol 1e-5,
parameters at rtol 5e-3 and atol 1e-3, BatchNorm statistics at rtol
5e-3 and atol 1e-4 (that test's tolerances); and the TTA predict over
the group equals the one-process predict (rtol 1e-5, atol 1e-6). Also
the mesh helpers in one process."""
import numpy as np
import pytest
import torch

from salt_tpu_torch.core.config import default_config
from salt_tpu_torch.parallel import mesh as mesh_mod
from salt_tpu_torch.parallel.mesh import Mesh, pad_to_multiple, shard_batch

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

STEPS = 3


def _cfg():
    cfg = default_config()
    cfg.model.architecture = "SaltUNet"
    cfg.model.n_filters = 8
    cfg.model.repeat_blocks = 2
    cfg.model.dropout_2d = 0.3
    cfg.training.dtype = "float32"
    cfg.training.loss = "lovasz"
    return cfg


def _batch():
    rng = np.random.RandomState(3)
    images = (rng.rand(16, 101, 101) * 255).astype(np.uint8)
    masks = (rng.rand(16, 101, 101) > 0.6).astype(np.uint8)
    return torch.from_numpy(images), torch.from_numpy(masks)


def _run(mesh):
    """STEPS train steps and a TTA predict: over ``mesh`` when given, else
    the one-process steps. Returns (losses, flat variables, probs)."""
    from salt_tpu_torch.models.convert import to_flax_flat
    from salt_tpu_torch.train.steps import SegmentationRunner
    runner = SegmentationRunner(_cfg(), "cpu")
    state = runner.init_state(0)
    images, masks = _batch()
    losses = []
    for i in range(STEPS):
        g = torch.Generator().manual_seed(i)
        if mesh is None:
            loss = runner.train_step(state, images, masks, g)
        else:
            loss = mesh_mod.data_parallel_train_step(runner, state, images,
                                                     masks, g, mesh)
        losses.append(float(loss))
    model = runner.init_model(0)
    if mesh is None:
        probs = runner.predict_dataset(model, images.numpy(), batch_size=8,
                                       tta=True)
    else:
        probs = mesh_mod.predict_dataset(runner, model, images.numpy(), mesh,
                                         batch_size=8, tta=True)
    return losses, to_flax_flat(state.model), probs


@pytest.fixture(scope="module")
def runs():
    return {1: _run(None), 2: mesh_mod.run_group(_run, 2)}


def test_train_steps_one_process_vs_two(runs):
    (l1, v1, _), (l2, v2, _) = runs[1], runs[2]
    np.testing.assert_allclose(l1, l2, rtol=1e-4, atol=1e-5)
    assert set(v1) == set(v2)
    for key, want in v1.items():
        if key.startswith("params/"):
            np.testing.assert_allclose(v2[key], want, rtol=5e-3, atol=1e-3,
                                       err_msg=f"param diverged: {key}")
        else:
            np.testing.assert_allclose(
                v2[key], want, rtol=5e-3, atol=1e-4,
                err_msg=f"batch_stats diverged (cross-rank BN): {key}")


def test_predict_one_process_vs_two(runs):
    p1, p2 = runs[1][2], runs[2][2]
    assert p1.shape == p2.shape == (16, 2, 101, 101)
    np.testing.assert_allclose(p2, p1, rtol=1e-5, atol=1e-6)


def test_shard_batch_takes_each_ranks_slice():
    x = np.arange(12).reshape(6, 2)
    parts = [shard_batch(x, Mesh(r, 3, torch.device("cpu")))
             for r in range(3)]
    assert [p.tolist() for p in parts] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]],
                                            [[8, 9], [10, 11]]]
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(x, Mesh(0, 4, torch.device("cpu")))
    assert pad_to_multiple(10, 4) == 12 and pad_to_multiple(8, 4) == 8


def test_make_mesh_without_a_group():
    """No process group: a world of one, or the JAX error for more."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="requested 2 devices"):
        mesh_mod.make_mesh(2, device="cpu")


def _bench_body(mesh):
    from salt_tpu_torch.tools.bench import (bench_config,
                                            measure_multichip_dp_tta)
    return measure_multichip_dp_tta(bench_config(tiny=True), "cpu", 1.0, 1,
                                    1)


def test_bench_multichip_dp_tta_over_two_ranks():
    """The bench's weak-scaling probe runs over a group of 2 (tiny, on
    the CPU: a check of the path, not a rate)."""
    out = mesh_mod.run_group(_bench_body, 2)
    assert out["chips"] == 2 and out["value"] > 0
    assert out["per_chip"] == pytest.approx(out["value"] / 2)

