"""The port's encoders against the flax ones: ResNet-50 (Bottleneck),
SE-ResNet-50 (SE gates, the stride on ``conv1``), SE-ResNeXt-50 (32
groups of width 4) and DenseNet-121 (dense layers, transitions), on the
same numpy-seeded weights carried through ``from_flax_flat``.

Batch 1 at 32x32 (stage maps 16, 8, 4, 2). Eval mode in fp32, at rtol =
atol = 2e-3, the whole-model tolerance of
tests/test_flagship_golden.py:220. Train mode normalises enc5 over 4
values a channel, which amplifies fp32 rounding: on ResNet-50 here the
port's fp32 enc5 is 8.6e-3 and flax's 1.8e-2 from their float64 forward,
while the two float64 forwards agree to 3e-11. So train mode runs both
packages in float64 and holds the features and the BatchNorm statistics
after the forward (the port moves ``running_var`` by the biased
variance, as flax does) at 1e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flatten, numpy_jax_variables

from salt_tpu.models.encoders import make_encoder as jax_make_encoder
from salt_tpu_torch.models.convert import load_flax_flat, to_flax_flat
from salt_tpu_torch.models.encoders import make_encoder

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

ENCODERS = [("resnet", 50), ("se_resnet", 50), ("se_resnext", 50),
            ("densenet", 121)]
TOL = dict(rtol=2e-3, atol=2e-3)
TOL64 = dict(rtol=1e-7, atol=1e-7)


@pytest.fixture(scope="module")
def image():
    rng = np.random.RandomState(11)
    return rng.randn(1, 32, 32, 3).astype(np.float32)


def _jax_forward(kind, depth, variables, image, train):
    """The flax encoder's features (and, in train mode, its new
    batch_stats), jitted; train mode in float64."""
    if not train:
        enc = jax_make_encoder(kind, depth)
        return jax.jit(lambda v, x: enc.apply(v, x, train=False))(
            variables, image), None
    with jax.enable_x64(True):
        enc = jax_make_encoder(kind, depth, dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        feats, mutated = jax.jit(lambda v, x: enc.apply(
            v, x, train=True, mutable=["batch_stats"]))(
                v64, jnp.asarray(image, jnp.float64))
        return ([np.asarray(f) for f in feats],
                flatten({"batch_stats": mutated["batch_stats"]}))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind,depth", ENCODERS,
                         ids=[f"{k}{d}" for k, d in ENCODERS])
def test_encoder_matches_flax(kind, depth, train, image):
    variables, flat = numpy_jax_variables(jax_make_encoder(kind, depth),
                                          seed=5)
    want, want_stats = _jax_forward(kind, depth, variables, image, train)

    enc = load_flax_flat(make_encoder(kind, depth), flat).train(train)
    x = torch.from_numpy(image).permute(0, 3, 1, 2)
    if train:
        enc, x = enc.double(), x.double()
    tol = TOL64 if train else TOL
    with torch.no_grad():
        got = enc(x)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), **tol)
    if train:
        got_stats = {k: v for k, v in to_flax_flat(enc).items()
                     if k.startswith("batch_stats/")}
        assert set(got_stats) == set(want_stats)
        for k in want_stats:
            np.testing.assert_allclose(got_stats[k], want_stats[k],
                                       err_msg=k, **tol)


def test_stride_sits_where_jax_puts_it():
    """SE-ResNet strides the 1x1 ``conv1`` (Caffe style), SE-ResNeXt and
    torchvision ResNet the 3x3 ``conv2``, which pads (1, 1) explicitly."""
    se = make_encoder("se_resnet", 50).layer2_0
    assert se.conv1.stride == (2, 2) and se.conv2.stride == (1, 1)
    for kind in ("resnet", "se_resnext"):
        block = make_encoder(kind, 50).layer2_0
        assert block.conv1.stride == (1, 1) and block.conv2.stride == (2, 2)
        assert block.conv2.padding == (1, 1)
    assert make_encoder("se_resnext", 50).layer1_0.conv2.groups == 32
    assert make_encoder("resnet", 50).layer1_0.se is None


def test_stride2_basic_block_pads_one_one_not_same():
    """On an even map a stride-2 3x3 conv with flax SAME would pad (0, 1);
    the JAX blocks pad (1, 1) explicitly, and so does the port: ResNet-18
    at 16x16 against flax."""
    jax_enc = jax_make_encoder("resnet", 18)
    variables, flat = numpy_jax_variables(jax_enc, seed=2)
    x = np.random.RandomState(3).randn(1, 16, 16, 3).astype(np.float32)
    want = jax.jit(lambda v, x: jax_enc.apply(v, x, train=False))(
        variables, x)
    enc = load_flax_flat(make_encoder("resnet", 18), flat).eval()
    with torch.no_grad():
        got = enc(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), **TOL)


def test_batch_norm_with_one_value_a_channel_matches_flax():
    """Train mode on a [1, C, 1, 1] map (ResNet-18 enc5 at a 16x16
    input, batch 1): flax normalises to its shift and moves the running
    variance towards 0; the fused torch update would divide by n - 1."""
    import flax.linen as fnn
    from salt_tpu_torch.models.blocks import batch_norm
    rng = np.random.RandomState(8)
    x = rng.randn(1, 1, 1, 6).astype(np.float32)
    scale, shift = rng.rand(6).astype(np.float32) + 0.5, rng.randn(6)
    mean, var = rng.randn(6), rng.rand(6) + 0.5
    variables = {"params": {"scale": scale, "bias": shift.astype(np.float32)},
                 "batch_stats": {"mean": mean.astype(np.float32),
                                 "var": var.astype(np.float32)}}
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    want, mutated = bn.apply(variables, x, mutable=["batch_stats"])
    port = batch_norm(6).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(shift))
        port.running_mean.copy_(torch.from_numpy(mean))
        port.running_var.copy_(torch.from_numpy(var))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    # x - mean is rounding noise, times 1 / sqrt(eps) = 316: 1e-4 bounds
    # 316 ulps of x around the shift
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=0, atol=1e-4)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(
            mutated["batch_stats"][key]), rtol=1e-6, atol=1e-6)
