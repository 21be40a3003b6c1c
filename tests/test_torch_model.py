"""Whole-forward parity: UNetResNet18 logits of the port vs the flax model
on the same JAX-initialised weights (BN statistics redrawn from a numpy
seed) carried through ``from_flax_flat``, in the default build and in the
reference-parity build. Tolerance rtol=atol=2e-3, the whole-model
tolerance of tests/test_flagship_golden.py (fp32 on the CPU; the packages
sum convolutions in different orders). Depth 18 keeps the CPU cost down;
the structure is the flagship's."""
import numpy as np
import pytest
import torch

from torch_parity import (flagship_config, port_config, seeded_images,
                          seeded_jax_variables)

from salt_tpu.models.registry import build_model as jax_build_model
from salt_tpu.ops.preprocess import preprocess_inference as jax_preprocess
from salt_tpu_torch.models.convert import load_flax_flat
from salt_tpu_torch.models.registry import build_model, init_seeded

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

MODES = [("same", "half_pixel"), ("reference", "align_corners")]


@pytest.mark.parametrize("pad_mode,upsample_mode", MODES,
                         ids=["default", "reference"])
def test_forward_logits_match_flax(pad_mode, upsample_mode):
    cfg = flagship_config(18, pad_mode, upsample_mode)
    jax_model = jax_build_model(cfg.model, "float32")
    variables, flat = seeded_jax_variables(jax_model, seed=0)
    x = np.asarray(jax_preprocess(seeded_images(2, seed=1)))
    want = np.asarray(jax_model.apply(variables, x, train=False))

    model = load_flax_flat(build_model(port_config(cfg).model), flat)
    with torch.no_grad():
        got = model(torch.tensor(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32 and got.shape == (2, 2, 128, 128)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=2e-3, atol=2e-3)


def test_flagship_shapes_and_bf16_head():
    """UNetResNet34 (the flagship) at full width: the encoder's stage
    sizes, fp32 logits from a bf16 trunk, parameter count of the JAX
    model."""
    from salt_tpu_torch.core.config import default_config
    cfg = default_config()
    model = init_seeded(build_model(cfg.model), seed=0)
    x = torch.randn(1, 3, 128, 128)
    feats = model.encoder(x)
    assert [f.shape[-1] for f in feats] == [64, 32, 16, 8]
    assert [f.shape[1] for f in feats] == [64, 128, 256, 512]
    import jax
    import jax.numpy as jnp
    jax_model = jax_build_model(cfg.model, "bfloat16")
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False))
    want = sum(int(np.prod(leaf.shape))
               for leaf in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == want
    model.set_compute_dtype(torch.bfloat16)
    assert model.head.weight.dtype == torch.float32
    assert model.center_conv1.Conv_0.weight.dtype == torch.bfloat16
    with torch.no_grad():
        out = model(x)
    assert out.dtype == torch.float32 and out.shape == (1, 2, 128, 128)
    assert torch.isfinite(out).all()


def test_registry_validates_and_names_unported():
    from salt_tpu_torch.core.config import default_config
    cfg = default_config()
    cfg.model.upsample_mode = "bicubic"
    with pytest.raises(ValueError, match="upsample_mode"):
        build_model(cfg.model)
    cfg = default_config()
    cfg.model.architecture = "PSPNet"            # ported: it builds
    assert type(build_model(cfg.model)).__name__ == "PSPNet"
    cfg.model.architecture = "PSPNetX"           # no such architecture
    with pytest.raises(KeyError):
        build_model(cfg.model)
    cfg.model.architecture = "SaltUNet"          # ported: it builds
    assert type(build_model(cfg.model)).__name__ == "SaltUNet"
    cfg = default_config()
    cfg.model.encoder_depth = 50                 # ported: Bottleneck blocks
    assert type(build_model(cfg.model).encoder.layer1_0).__name__ == \
        "Bottleneck"
    cfg.model.encoder_depth = 77                 # no such ResNet, as in JAX
    with pytest.raises(KeyError):
        build_model(cfg.model)
