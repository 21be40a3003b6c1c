"""Whole U-Net trunks of the new encoders against flax: SE-ResNet-50,
SE-ResNeXt-50 and DenseNet-121 under the JAX package's ``UNetTrunk``
with a narrowed ``bottom_channels`` (128: the decoder at 16 channels, the
encoder at its real widths), 64x64, batch 1, fp32, eval mode, on the
same numpy-seeded weights carried through ``from_flax_flat``.

Both forms: the port's train form (literal concats) against the flax
trunk built with ``decoder_impl = hypercolumn_impl = "concat"`` (the JAX
runner's train graph), its infer form against the "sum" build (the
predict graphs). DenseNet's center emits enc4's width (``center_out``),
as ``UNetDenseNet`` builds it. Tolerance rtol = atol = 2e-3
(tests/test_flagship_golden.py:220).
"""
import jax
import numpy as np
import pytest
import torch

from torch_parity import numpy_jax_variables

from salt_tpu.models.unet import UNetTrunk as JaxUNetTrunk
from salt_tpu_torch.models.convert import load_flax_flat
from salt_tpu_torch.models.encoders import encoder_channels
from salt_tpu_torch.models.unet import UNetTrunk

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

BOTTOM = 128
TRUNKS = [("se_resnet", 50), ("se_resnext", 50), ("densenet", 121)]


def _center_out(kind, depth):
    return encoder_channels(kind, depth)[2] if kind == "densenet" else 0


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(21).randn(1, 64, 64, 3).astype(np.float32)


@pytest.mark.parametrize("form", ["train", "infer"])
@pytest.mark.parametrize("kind,depth", TRUNKS,
                         ids=[f"{k}{d}" for k, d in TRUNKS])
def test_trunk_matches_flax(kind, depth, form, image):
    impl = "concat" if form == "train" else "sum"
    fields = dict(encoder_kind=kind, encoder_depth=depth,
                  bottom_channels=BOTTOM,
                  center_out=_center_out(kind, depth))
    jax_trunk = JaxUNetTrunk(hypercolumn_impl=impl, decoder_impl=impl,
                             **fields)
    variables, flat = numpy_jax_variables(jax_trunk, seed=7)
    want = jax.jit(lambda v, x: jax_trunk.apply(v, x, train=False))(
        variables, image)

    trunk = load_flax_flat(UNetTrunk(**fields), flat).eval()
    with torch.no_grad():
        got = trunk(torch.from_numpy(image).permute(0, 3, 1, 2),
                    infer=form == "infer")
    assert got.dtype == torch.float32 and got.shape == (1, 2, 64, 64)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=2e-3, atol=2e-3)
