"""The blocks of LargeKernelMatters and PSPNet against the JAX package's
(``salt_tpu/models/blocks.py``): ``resize_bilinear`` in both modes,
``DeconvConvBnRelu`` in both pad modes, ``GlobalConvolutionalNetwork``
and ``BoundaryRefinement``, on numpy-seeded inputs and weights carried by
``models.convert``. fp32, eval mode, at rtol = atol = 2e-4, the conv
kernels' tolerance of tests/test_pallas_conv.py:28 (a block is a few
convs deep); the resize is a weighted sum of at most a few values, held
at 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flatten

from salt_tpu.models import blocks as jb
from salt_tpu_torch.models import blocks
from salt_tpu_torch.models.convert import load_flax_flat, to_flax_flat

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("mode", ["half_pixel", "align_corners"])
@pytest.mark.parametrize("size", [1, 2, 3, 6])
def test_resize_bilinear_matches_jax(size, mode):
    """The PSP priors, pooled to 1, 2, 3 and 6, back up to 8 and down to
    4 (a 64x64 input's enc5: JAX antialiases when it shrinks)."""
    rng = np.random.RandomState(size)
    x = rng.randn(2, size, size, 5).astype(np.float32)
    for out in (8, 4, 11):
        want = np.asarray(jax.jit(lambda a: jb.resize_bilinear(
            a, out, out, mode=mode))(jnp.asarray(x)))
        got = _nhwc(blocks.resize_bilinear(_nchw(x), out, out, mode))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _seeded(module, x, seed):
    """flax init of ``module`` on ``x``, then the BatchNorm statistics and
    scales redrawn from numpy seed ``seed``."""
    variables = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    flat = flatten(variables)
    rng = np.random.RandomState(seed)
    for key in sorted(flat):
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("scale", "var"):
            flat[key] = (0.8 + 0.4 * rng.rand(*flat[key].shape)).astype(
                np.float32)
        elif leaf in ("mean", "bias"):
            flat[key] = (0.1 * rng.randn(*flat[key].shape)).astype(
                np.float32)
    from torch_parity import unflatten_like
    return unflatten_like(flat, variables), flat


def _check(jax_module, port_module, c_in, seed, hw=(12, 10)):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *hw, c_in).astype(np.float32)
    variables, flat = _seeded(jax_module, x, seed)
    want = np.asarray(jax.jit(lambda v, a: jax_module.apply(v, a))(
        variables, jnp.asarray(x)))
    port = load_flax_flat(port_module, flat).eval()
    assert set(to_flax_flat(port)) == set(flat)
    for k, v in to_flax_flat(port).items():
        np.testing.assert_array_equal(v, flat[k])
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("pad_mode", ["same", "reference"])
def test_deconv_conv_bn_relu_matches_jax(pad_mode):
    """flax's unflipped transposed conv, padded (2, 1) ("SAME") or (1, 2)
    ("reference") on the stride-dilated input: H and W double."""
    _check(jb.DeconvConvBnRelu(7, pad_mode=pad_mode),
           blocks.DeconvConvBnRelu(5, 7, pad_mode), 5, seed=1)


@pytest.mark.parametrize("pad_mode", ["same", "reference"])
def test_global_convolutional_network_matches_jax(pad_mode):
    _check(jb.GlobalConvolutionalNetwork(6, 9, use_relu=True,
                                         pad_mode=pad_mode),
           blocks.GlobalConvolutionalNetwork(8, 6, 9, True, pad_mode), 8,
           seed=2)


@pytest.mark.parametrize("pad_mode", ["same", "reference"])
def test_boundary_refinement_matches_jax(pad_mode):
    _check(jb.BoundaryRefinement(6, 3, pad_mode=pad_mode),
           blocks.BoundaryRefinement(6, 3, pad_mode), 6, seed=3)
