"""The architectures of the port's registry against the JAX registry's:
for every (architecture, encoder_depth) the JAX registry builds,
``to_flax_flat(build_model(cfg))`` has exactly the flat keys and shapes
of the flax model's variables (traced with ``jax.eval_shape``, which
compiles nothing), so either package loads the other's ``best.npz``.
Also the registry's ``encoder_depth`` coercions, ``takes_depth`` and the
five architectures still unported."""
import pytest
import torch

from torch_parity import arch_configs, check_keys_and_shapes

from salt_tpu.models.registry import takes_depth as jax_takes_depth
from salt_tpu_torch.models.registry import (NOT_PORTED, build_model,
                                            init_seeded, takes_depth)

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

#: the ResNet U-Nets here; SE-ResNet, SE-ResNeXt and DenseNet in
#: tests/test_torch_arch_keys_se.py (a file runs on one test worker)
ARCHS = ([("UNetResNet", d) for d in (18, 34, 50, 101, 152)]
         + [("UNetResNetWithDepth", d) for d in (18, 34, 50)])


@pytest.mark.parametrize("arch,depth", ARCHS,
                         ids=[f"{a}-{d}" for a, d in ARCHS])
def test_flat_keys_and_shapes_match_jax(arch, depth):
    check_keys_and_shapes(arch, depth)


def test_registry_coerces_encoder_depth_as_jax_does():
    """The default config's encoder_depth 34 builds SE-ResNet-50,
    SE-ResNeXt-50 and DenseNet-121 (JAX ``registry.py:71,84,97``), and
    ResNet keeps 34."""
    expect = {"UNetResNet": ("BasicBlock", 34),
              "UNetSeResNet": ("Bottleneck", 50),
              "UNetSeResNetXt": ("Bottleneck", 50),
              "UNetDenseNet": ("DenseLayer", 121)}
    for arch, (block, depth) in expect.items():
        _, pcfg = arch_configs(arch, 34)
        enc = build_model(pcfg.model).encoder
        first = enc.layer1_0 if hasattr(enc, "layer1_0") else \
            enc.denseblock1_0
        assert type(first).__name__ == block
        n = sum(1 for name, _ in enc.named_children()
                if name.startswith(("layer", "denseblock")))
        assert n == {34: 16, 50: 16, 121: 58}[depth], arch


def test_depth_model_ignores_pool0_and_the_sum_forms():
    """The JAX builder passes no pool0, decoder_impl or hypercolumn_impl
    to UNetResNetWithDepth: the same weights give the same logits."""
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    d = torch.tensor([[0.4]])
    outs = []
    for model_kw in ({}, {"pool0": True, "decoder_impl": "concat",
                          "hypercolumn_impl": "concat"}):
        _, pcfg = arch_configs("UNetResNetWithDepth", 18, **model_kw)
        model = init_seeded(build_model(pcfg.model), seed=2)
        with torch.no_grad():
            outs.append([model(x, depth=d), model(x, infer=True, depth=d)])
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_not_ported_names_the_five_left():
    assert set(NOT_PORTED) == {"LargeKernelMatters", "PSPNet",
                               "StackingFCN", "StackingFCNWithDepth",
                               "EmptinessClassifier"}
    for arch in NOT_PORTED:
        _, pcfg = arch_configs(arch, 34)
        with pytest.raises(NotImplementedError, match="item 13"):
            build_model(pcfg.model)
    for arch in ("UNetResNetWithDepth", "StackingFCNWithDepth",
                 "UNetResNet", "UNetDenseNet", "SaltUNet"):
        assert takes_depth(arch) == jax_takes_depth(arch)
