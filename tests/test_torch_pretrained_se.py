"""``model.pretrained`` with a pretrainedmodels-layout se_resnet-50
checkpoint (``layer0.`` stem, ``se_module.fc1/fc2`` gates; the builder
of tests/test_arch_goldens.py) grafted into UNetSeResNet-50, from an
``.npz`` and a ``.pth``: the encoder equals the JAX package's graft leaf
for leaf, and its features match the flax encoder's (fp32, 32x32, rtol
= atol = 2e-3). The checks are tests/test_torch_pretrained.py's; the
168M-parameter model has a file of its own."""
import pytest
import torch

from test_torch_pretrained import (check_encoder_equals_jax_graft,
                                   check_grafted_forward, graft_case)

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def grafted(tmp_path_factory):
    return graft_case("se_resnet50", tmp_path_factory.mktemp("se_resnet50"))


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_encoder_equals_jax_graft(grafted, fmt):
    check_encoder_equals_jax_graft(grafted, fmt)


def test_grafted_forward_matches_jax(grafted):
    check_grafted_forward(grafted)
