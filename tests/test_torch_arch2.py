"""LargeKernelMatters, PSPNet (with the hypercolumn and without),
StackingFCN, StackingFCNWithDepth and EmptinessClassifier against the
JAX registry's models, on numpy-seeded weights carried by
``models.convert``: fp32 logits in eval mode, and in train mode the
logits and the BatchNorm statistics after the forward, at rtol = atol =
2e-3, the whole-model tolerance of tests/test_flagship_golden.py:220.
ResNet-18 encoders at a 64x64 input, batch 2 (the stacking heads take 18
probability maps); every key and shape of the flax variables, both ways
through the bridge; the registry builds every JAX architecture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (arch_configs, check_keys_and_shapes, flatten,
                          input_channels, numpy_jax_variables)

from salt_tpu.models.registry import ARCHITECTURES
from salt_tpu.models.registry import build_model as jax_build_model
from salt_tpu.models.registry import takes_depth
from salt_tpu_torch.models.convert import load_flax_flat, to_flax_flat
from salt_tpu_torch.models.registry import NOT_PORTED, build_model

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

TOL = dict(rtol=2e-3, atol=2e-3)
CASES = [("LargeKernelMatters", {}),
         ("LargeKernelMatters", {"conv_pad_mode": "reference"}),
         ("PSPNet", {}), ("PSPNet", {"use_hypercolumn": False}),
         ("PSPNet", {"upsample_mode": "align_corners"}),
         ("StackingFCN", {}), ("StackingFCNWithDepth", {}),
         ("EmptinessClassifier", {})]
IDS = [a + "".join(f"-{v}" for v in kw.values()) for a, kw in CASES]


def _forward(arch, model_kw, train):
    cfg, pcfg = arch_configs(arch, 18, **model_kw)
    jm = jax_build_model(cfg.model, "float32")
    depth = takes_depth(arch)
    channels = input_channels(cfg.model)
    variables, flat = numpy_jax_variables(jm, seed=1, depth=depth,
                                          channels=channels)
    rng = np.random.RandomState(0)
    x = rng.rand(2, 64, 64, channels).astype(np.float32)
    if channels == 3:
        x = (x - 0.5) / 0.25
    d = rng.rand(2, 1).astype(np.float32)
    extra = (jnp.asarray(d),) if depth else ()
    if train:
        want, mutated = jax.jit(lambda v, a, *e: jm.apply(
            v, a, *e, train=True, mutable=["batch_stats"]))(
                variables, jnp.asarray(x), *extra)
        want_stats = flatten({"batch_stats": mutated["batch_stats"]})
    else:
        want = jax.jit(lambda v, a, *e: jm.apply(v, a, *e, train=False))(
            variables, jnp.asarray(x), *extra)
        want_stats = None
    model = load_flax_flat(build_model(pcfg.model), flat).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2),
                    depth=torch.from_numpy(d) if depth else None)
    got = got.numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    return np.asarray(want), got, want_stats, model


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("arch,model_kw", CASES, ids=IDS)
def test_model_matches_jax(arch, model_kw, train):
    want, got, want_stats, model = _forward(arch, model_kw, train)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    if train:
        have = to_flax_flat(model)
        for key, value in want_stats.items():
            np.testing.assert_allclose(have[key], value, **TOL)


@pytest.mark.parametrize("arch", ["LargeKernelMatters", "PSPNet",
                                  "StackingFCN", "StackingFCNWithDepth",
                                  "EmptinessClassifier"])
def test_keys_and_shapes_round_trip(arch):
    """The port's flat keys and shapes are the flax model's (traced at
    encoder_depth 34, the default config's), and the bridge carries
    JAX's arrays into the port and back unchanged."""
    check_keys_and_shapes(arch, 34)
    cfg, pcfg = arch_configs(arch, 18)
    _, flat = numpy_jax_variables(jax_build_model(cfg.model, "float32"),
                                  seed=2, depth=takes_depth(arch),
                                  channels=input_channels(cfg.model))
    back = to_flax_flat(load_flax_flat(build_model(pcfg.model), flat))
    assert sorted(back) == sorted(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value)


def test_registry_builds_every_jax_architecture():
    """Every name of the JAX registry builds (the four U-Net factories
    return ``UNetTrunk``), with JAX's ``takes_depth``."""
    assert NOT_PORTED == ()
    for arch in ARCHITECTURES:
        _, pcfg = arch_configs(arch, 34)
        model = build_model(pcfg.model)
        assert type(model).__name__ in (arch, "UNetTrunk")
        assert model.takes_depth == takes_depth(arch)
