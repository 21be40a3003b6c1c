"""The SE-ResNet, SE-ResNeXt and DenseNet U-Nets of the port's registry
against the JAX registry's: for every ``encoder_depth`` the JAX registry
builds, the same flat keys and shapes (tests/test_torch_arch_keys.py
holds the ResNet ones); and the seeded initializers over the new layers
(SE biases, grouped convs, the depth gate's ``Linear``)."""
import numpy as np
import pytest
import torch

from test_torch_arch_keys import arch_configs, check_keys_and_shapes

from salt_tpu_torch.models.encoders import make_encoder
from salt_tpu_torch.models.registry import (build_model, init_flax_like,
                                            init_seeded)

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

ARCHS = ([("UNetSeResNet", d) for d in (50, 101, 152)]
         + [("UNetSeResNetXt", d) for d in (50, 101)]
         + [("UNetDenseNet", d) for d in (121, 161, 169, 201)])


@pytest.mark.parametrize("arch,depth", ARCHS,
                         ids=[f"{a}-{d}" for a, d in ARCHS])
def test_flat_keys_and_shapes_match_jax(arch, depth):
    check_keys_and_shapes(arch, depth)


def test_seeded_initializers_cover_the_new_layers():
    """SE biases, grouped conv kernels and the depth gate's Linear are
    drawn by ``init_seeded`` (no torch default left) and start as flax
    starts them in ``init_flax_like`` (biases 0, fan-in over one group)."""
    model = make_encoder("se_resnext", 50)
    block = model.layer1_0
    init_seeded(model, seed=1)
    se_bias = block.se.fc1.bias.detach().numpy()
    assert 0 < np.abs(se_bias).max() < 0.05 * 6
    init_flax_like(model, seed=1)
    assert float(block.se.fc1.bias.detach().abs().max()) == 0.0
    w = block.conv2.weight                  # [128, 4, 3, 3]: 32 groups
    assert tuple(w.shape) == (128, 4, 3, 3)
    std = (1.0 / 36) ** 0.5
    assert abs(float(w.detach().std()) - std) < 0.15 * std
    _, pcfg = arch_configs("UNetResNetWithDepth", 18)
    model = init_seeded(build_model(pcfg.model), seed=3)
    gate = model.depth_gate.Dense_0
    assert tuple(gate.weight.shape) == (320, 1)
    assert float(gate.bias.detach().abs().max()) > 0
    init_flax_like(model, seed=3)
    assert float(gate.bias.detach().abs().max()) == 0.0
