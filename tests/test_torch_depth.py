"""The depth-gated U-Net against the JAX package's: UNetResNetWithDepth-18
at its real widths (bottom 512, the gate over the 320-channel
hypercolumn), batch 2, depths (0.25, 0.8), from the JAX registry's
model on the same numpy-seeded weights; both of the port's forms against
it (the JAX model is one build: its trunk keeps the "sum" decoder and
the flax default head input in the train graph too). Tolerance rtol =
atol = 2e-3 (tests/test_flagship_golden.py:220).

Also: the depths reach the logits; one ``best.npz`` crosses both ways;
``execution.use_depth`` with a model that takes no depth raises
``TypeError`` where JAX's ``init_state`` does."""
import jax
import numpy as np
import pytest
import torch

from torch_parity import arch_configs, numpy_jax_variables, seeded_images

from salt_tpu.core.experiment import Experiment as JaxExperiment
from salt_tpu.models.registry import build_model as jax_build_model
from salt_tpu.ops.preprocess import preprocess_inference as jax_preprocess
from salt_tpu.pipeline.serving import _load_flat_npz
from salt_tpu.train.steps import SegmentationRunner as JaxRunner
from salt_tpu_torch.core.experiment import save_flat_npz
from salt_tpu_torch.models.convert import load_flax_flat, to_flax_flat
from salt_tpu_torch.models.registry import build_model, init_seeded
from salt_tpu_torch.train.steps import SegmentationRunner

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

DEPTHS = np.array([[0.25], [0.8]], np.float32)
TOL = dict(rtol=2e-3, atol=2e-3)


def _jax_apply(model, variables, x, d):
    return np.asarray(jax.jit(lambda v, x, d: model.apply(
        v, x, d, train=False))(variables, x, d))


@pytest.fixture(scope="module")
def depth_net():
    cfg, pcfg = arch_configs("UNetResNetWithDepth", 18)
    jax_model = jax_build_model(cfg.model, "float32")
    variables, flat = numpy_jax_variables(jax_model, seed=4, depth=True)
    x = np.asarray(jax_preprocess(seeded_images(2, seed=5)))
    want = _jax_apply(jax_model, variables, x, DEPTHS)
    return cfg, pcfg, jax_model, variables, flat, x, want


def _port(pcfg, flat):
    return load_flax_flat(build_model(pcfg.model), flat)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("form", ["train", "infer"])
def test_forward_matches_jax_registry_model(depth_net, form):
    _, pcfg, _, _, flat, x, want = depth_net
    model = _port(pcfg, flat)
    with torch.no_grad():
        got = model(_nchw(x), infer=form == "infer",
                    depth=torch.from_numpy(DEPTHS))
    assert got.dtype == torch.float32 and got.shape == (2, 2, 128, 128)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


def test_depths_reach_the_logits(depth_net):
    """Only the depths change, and the logits move, on both sides."""
    _, pcfg, jax_model, variables, flat, x, want = depth_net
    other = DEPTHS[::-1].copy()
    model = _port(pcfg, flat)
    with torch.no_grad():
        got = model(_nchw(x), depth=torch.from_numpy(other))
    want_other = _jax_apply(jax_model, variables, x, other)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want_other,
                               **TOL)
    assert np.abs(want_other - want).max() > 10 * TOL["atol"]
    with pytest.raises(TypeError, match="depth"):
        model(_nchw(x))


def test_best_npz_crosses_both_ways(depth_net, tmp_path):
    cfg, pcfg, jax_model, variables, flat, x, want = depth_net
    # JAX's best.npz served by the port
    exp = JaxExperiment(str(tmp_path / "jax"))
    path = exp.save_params("network", {"params": variables["params"],
                                       "batch_stats": variables["batch_stats"]})
    model = SegmentationRunner(pcfg, "cpu").restore(path)
    with torch.no_grad():
        got = model(_nchw(x), depth=torch.from_numpy(DEPTHS))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
    # the port's best.npz read by JAX
    port_model = init_seeded(build_model(pcfg.model), seed=8)
    out = save_flat_npz(str(tmp_path / "port" / "best.npz"),
                        to_flax_flat(port_model))
    restored = _load_flat_npz(out, jax.tree.map(np.zeros_like, variables))
    with torch.no_grad():
        got = port_model(_nchw(x), depth=torch.from_numpy(DEPTHS))
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).numpy(),
        _jax_apply(jax_model, restored, x, DEPTHS), **TOL)


def test_use_depth_without_a_depth_model_raises_as_jax_does():
    cfg, pcfg = arch_configs("UNetResNet", 18)
    cfg.execution.use_depth = pcfg.execution.use_depth = True
    with pytest.raises(TypeError):
        JaxRunner(cfg).init_state(0)
    runner = SegmentationRunner(pcfg, "cpu")
    assert runner.use_depth
    for make in (lambda: runner.init_state(0), lambda: runner.init_model(0)):
        with pytest.raises(TypeError, match="use_depth"):
            make()
