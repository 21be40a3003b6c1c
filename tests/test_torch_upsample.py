"""Upsampling parity: the port's ``upsample2x`` (``F.interpolate``) vs the
JAX package's (``jax.image.resize`` "linear" for half_pixel, the
align-corners interpolation matrices otherwise) at every factor the
flagship uses, edges included. Tolerance 1e-6 (fp32 rounding)."""
import numpy as np
import pytest
import torch

from salt_tpu.models.blocks import upsample2x as jax_upsample2x
from salt_tpu_torch.models.blocks import reference_pad, upsample2x


@pytest.mark.parametrize("mode", ["half_pixel", "align_corners"])
@pytest.mark.parametrize("factor", [2, 4, 8, 16])
def test_upsample_matches_jax(factor, mode):
    hw = 128 // factor
    x = np.random.RandomState(factor).randn(2, hw, hw + 1, 3).astype(np.float32)
    want = np.asarray(jax_upsample2x(x, factor, mode=mode))
    got = upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2), factor, mode)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6, rtol=0)


def test_reference_pad_matches_jax():
    from salt_tpu.models.blocks import reference_pad as jax_reference_pad
    x = np.random.RandomState(0).randn(1, 5, 6, 2).astype(np.float32)
    want = np.asarray(jax_reference_pad(x, 3, 3))
    got = reference_pad(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 3)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
