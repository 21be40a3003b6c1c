"""The int8 convs of ``model.quant_bits=8`` against the JAX package's:
AQT's ``conv_general_dilated`` (``salt_tpu/models/quant.py``), compiled,
on the CPU, one conv per geometry of the U-Nets' route (7x7 stride 2 over
3 channels, 3x3 stride 1 and 2, 1x1 stride 2, SE-ResNeXt's 32 groups, a
sliced-concat sum of two branches), in fp32 and in bf16.

- The integer operands and the scales (per image, per output channel)
  equal AQT's bit for bit.
- The outputs: in fp32 within one fp32 ulp of AQT's (AQT's fp32 sums of
  the integers are exact below 2^24, then the same two products); in bf16
  within two bf16 ulps (AQT rounds the integer sum to bf16 and rounds
  again after each scale, the port rounds once).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from salt_tpu.models.blocks import SlicedConcatConv
from salt_tpu.models.quant import make_conv_fn as jax_make_conv_fn
from salt_tpu_torch.models.blocks import sliced_concat_conv
from salt_tpu_torch.models.quant import make_conv_fn
from salt_tpu_torch.ops import int8_conv as ic

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

#: (name, batch, C, H, W, O, k, stride, padding, groups)
GEOMETRIES = [("stem_7x7_s2", 2, 3, 32, 32, 64, 7, 2, 3, 1),
              ("3x3_s1", 2, 64, 16, 16, 64, 3, 1, 1, 1),
              ("3x3_s2", 2, 64, 16, 16, 128, 3, 2, 1, 1),
              ("1x1_s2", 2, 64, 16, 16, 128, 1, 2, 0, 1),
              ("groups_32", 2, 128, 8, 8, 128, 3, 1, 1, 32)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _with_qt():
    """AQT's conv as the JAX package makes it, returning its quantized
    operands too."""
    from aqt.jax.v2.aqt_conv_general import (
        conv_general_dilated_make, make_conv_general_dilated_with_qt)
    return make_conv_general_dilated_with_qt(
        conv_general_dilated_make(2, lhs_bits=8, rhs_bits=8))


def _ulps(got, want, mantissa):
    want = np.asarray(want, np.float64)
    _, exp = np.frexp(want)
    ulp = np.ldexp(1.0, exp - mantissa)
    return float((np.abs(np.asarray(got, np.float64) - want) / ulp).max())


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("name,b,c,h,w,o,k,s,p,g", GEOMETRIES,
                         ids=[gm[0] for gm in GEOMETRIES])
def test_int8_conv_matches_aqt(name, b, c, h, w, o, k, s, p, g, jdt, tdt):
    rng = np.random.RandomState(k * 10 + s)
    x = (rng.randn(b, h, w, c) * 3).astype(np.float32)
    wt = (rng.randn(k, k, c // g, o) / np.sqrt(k * k * c / g)).astype(
        np.float32)
    xj, wj = jnp.asarray(x).astype(jdt), jnp.asarray(wt).astype(jdt)
    dn = lax.conv_dimension_numbers(xj.shape, wj.shape,
                                    ("NHWC", "HWIO", "NHWC"))
    qconv = _with_qt()
    out, (lq, rq) = jax.jit(lambda a, b_: qconv(
        a, b_, (s, s), ((p, p), (p, p)), dimension_numbers=dn,
        feature_group_count=g))(xj, wj)

    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    wt_t = torch.from_numpy(np.array(wj.astype(jnp.float32))).to(tdt)
    xt, wt_t = xt.permute(0, 3, 1, 2), wt_t.permute(3, 2, 0, 1)
    xq, sx = ic.quantize_activation(xt)
    wq, sw = ic.quantize_weight(wt_t)
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(lq.qvalue).astype(np.int8))
    np.testing.assert_array_equal(wq.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(rq.qvalue).astype(np.int8))
    np.testing.assert_array_equal(
        sx.numpy(), np.asarray(lq.scale[0].astype(jnp.float32)).ravel())
    np.testing.assert_array_equal(
        sw.numpy(), np.asarray(rq.scale[0].astype(jnp.float32)).ravel())

    got = make_conv_fn(8)(xt, wt_t, None, s, p, 1, g)
    assert got.dtype == tdt
    got = got.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(out.astype(jnp.float32))
    assert got.shape == want.shape
    limit = 1.0 if tdt == torch.float32 else 2.0
    assert _ulps(got, want, 24 if tdt == torch.float32 else 8) <= limit


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["fp32", "bf16"])
def test_sliced_concat_branches_quantize_each_on_its_own(jdt, tdt):
    """A sliced-concat sum (``SlicedConcatConv``): each branch quantized
    with its own activation scale and its slice of the weight with its
    own per-channel scales, the sums added in branch order in D."""
    rng = np.random.RandomState(5)
    branches = [(rng.randn(2, 16, 16, c) * sc).astype(np.float32)
                for c, sc in ((32, 1.0), (48, 4.0))]
    module = SlicedConcatConv(24, 80, dtype=jdt,
                              conv_fn=jax_make_conv_fn(8))
    variables = module.init(jax.random.PRNGKey(0),
                            [jnp.asarray(a).astype(jdt) for a in branches])
    want = np.asarray(jax.jit(lambda v, a, b_: module.apply(v, [a, b_]))(
        variables, *(jnp.asarray(a).astype(jdt) for a in branches)
    ).astype(jnp.float32))
    kernel = np.array(variables["params"]["kernel"])
    weight = torch.from_numpy(kernel).permute(3, 2, 0, 1).to(tdt)
    got = sliced_concat_conv(
        [torch.from_numpy(np.array(jnp.asarray(a).astype(jdt).astype(
            jnp.float32))).to(tdt).permute(0, 3, 1, 2) for a in branches],
        weight, make_conv_fn(8))
    got = got.float().permute(0, 2, 3, 1).numpy()
    # a sum of two branches: each within the per-conv limit above, then
    # one more rounding of the sum in D
    limit = 2.0 if tdt == torch.float32 else 4.0
    scale = np.abs(want).max()
    eps = 2.0 ** (-23 if tdt == torch.float32 else -7)
    assert float(np.abs(got - want).max()) <= limit * eps * scale


def test_int8_conv_fn_under_autocast_and_with_a_bias():
    """Under autocast the operands are quantized in the autocast dtype (as
    flax hands AQT bf16 operands); a bias is added after, in that dtype."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 16, 8, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(8, 16, 3, 3).astype(np.float32) / 12)
    bias = torch.from_numpy(rng.randn(8).astype(np.float32))
    conv = make_conv_fn(8)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = conv(x, w, bias, 1, 1)
    want = conv(x.bfloat16(), w.bfloat16(), None, 1, 1) + bias.bfloat16()[
        None, :, None, None]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert make_conv_fn(0) is None
    with pytest.raises(ValueError, match="quant_bits=4"):
        make_conv_fn(4)


def test_weights_are_quantized_anew_on_every_call():
    """Nothing is cached: after an optimizer step moves a weight, the next
    int8 conv quantizes the new values (the same result as a fresh copy
    of the weight), never a stale int8 copy of the old ones."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(1, 16, 8, 8).astype(np.float32))
    w = torch.nn.Parameter(torch.from_numpy(
        rng.randn(8, 16, 3, 3).astype(np.float32) / 12))
    conv = make_conv_fn(8)
    before = conv(x, w, None, 1, 1)
    opt = torch.optim.SGD([w], lr=0.5)
    (w.square().sum()).backward()
    opt.step()
    after = conv(x, w, None, 1, 1)
    assert not torch.equal(after, before)
    assert torch.equal(after, conv(x, w.detach().clone(), None, 1, 1))
