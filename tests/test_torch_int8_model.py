"""The int8 infer form of the flagship (``model.quant_bits=8``) against
the JAX package's: the convs the route quantizes, counted in both
packages, and UNetResNet-18 with ``pallas_conv`` "off" (fp32) and "on"
(bf16, the JAX conv kernel in interpret mode) on the same numpy-seeded
weights, site by site.

Two int8 forwards cannot be held against each other end to end: a value
that lands on the other side of a rounding boundary moves its conv's
output by a step of the scales, and the next convs carry it on. JAX's
own fp32 int8 forward of the test's input moves by 0.0065 at the worst
probability (0.00093 on the mean) when the input moves by one fp32 ulp,
about as far as from its float forward (0.0087, 0.00137), and the port's
float forward lies as close to JAX's int8 one as the port's int8 forward
does. So the test records, in one jitted JAX forward, the operand and the
result of every AQT conv, and runs the port's forward with each
quantized conv's result taken from JAX's (the float ops between the
convs, the conv kernel's convs and the head are the port's own). At each
site, in order:

- the port's operand (padded as its conv pads it) equals JAX's, padded
  by JAX's padding, within the float ops' rounding: fp32 2e-6 of the
  site's max (reading 2.8e-7), bf16 3% (reading 1.5%: a few bf16 ulps,
  the two packages round the bf16 ops apart);
- the port's int8 conv of JAX's operand, with the port's weight, equals
  JAX's AQT result: fp32 bit for bit (the s32 sums are exact and the
  dequantization rounds as AQT's), bf16 within 4 ulps of bf16 (reading
  3: AQT rounds its sums to bf16 before the scales apply), where a float
  conv in place of the int8 one is off by the quantization's own error,
  tens of ulps on the small outputs;

and the port's probabilities against JAX's int8 ones, masks under the
threshold-margin rule of tests/test_submission_parity.py:161-176 with
its fixed caps: fp32 within 1e-6 (reading 1.2e-7) and at most 5 pixels
within that delta of 0.5 (reading 0); bf16 within 4e-3 at the worst
pixel and 6e-4 on the mean (readings 2.1e-3 and 3.6e-4; the port's bf16
float forward is 5.7e-3 and 1.1e-3 from JAX's int8 one) and at most a
tenth of the pixels within that delta (reading 559 of 8192: the random
weights put every probability within 0.15 of 0.5). A float forward
quantizes no conv and fails the count of sites before any of these."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_parity import flagship_config, numpy_jax_variables, port_config

from salt_tpu.models.quant import make_conv_fn as jax_quant_conv_fn
from salt_tpu.models.unet import UNetResNet as JaxUNetResNet
from salt_tpu.ops.pallas_conv import make_pallas_conv_fn
from salt_tpu_torch.models import quant
from salt_tpu_torch.models.convert import load_flax_flat
from salt_tpu_torch.models.registry import build_model

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


def _counting(fn, calls):
    def conv(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)
    return conv


def _jax_sites(depth, pallas):
    """Calls of AQT's conv in one bf16 infer forward of JAX's flagship at
    128x128 (traced, nothing compiled)."""
    calls = []
    inner = _counting(jax_quant_conv_fn(8), calls)
    conv_fn = make_pallas_conv_fn(inner, interpret=True) if pallas else inner
    model = JaxUNetResNet(encoder_depth=depth, dtype=jnp.bfloat16,
                          conv_fn=conv_fn)
    x = jnp.zeros((1, 128, 128, 3), jnp.bfloat16)
    jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x))
    calls.clear()
    jax.eval_shape(lambda: model.apply(
        model.init(jax.random.PRNGKey(0), x), x))
    # init traced the forward once more inside the second eval_shape
    return len(calls) // 2


def _port_sites(depth, pallas_conv):
    cfg = port_config(flagship_config(depth))
    cfg.model.quant_bits = 8
    cfg.model.pallas_conv = pallas_conv
    model = build_model(cfg.model).set_compute_dtype(torch.bfloat16)
    calls = []
    conv = quant.conv2d_int8
    quant.conv2d_int8 = _counting(conv, calls)
    try:
        with torch.no_grad():
            model(torch.zeros(1, 3, 128, 128, dtype=torch.bfloat16),
                  infer=True)
    finally:
        quant.conv2d_int8 = conv
    return len(calls)


@pytest.mark.parametrize("depth,pallas,sites", [(18, False, 41),
                                                (34, False, 57),
                                                (34, True, 43)])
def test_routed_convs_match_jax(depth, pallas, sites):
    """The convs the int8 route takes in one infer forward: chip_smoke.py
    asserts 57 int8 conv launches a forward (43 with the conv kernel,
    which takes the 14 64 -> 64 convs), and tests/test_torch_cuda.py 41
    at depth 18."""
    assert _jax_sites(depth, pallas) == sites
    assert _port_sites(depth, "on" if pallas else "off") == sites


@pytest.fixture(scope="module")
def weights():
    model = JaxUNetResNet(encoder_depth=18)
    return numpy_jax_variables(model, seed=4)


def _jax_recorded(variables, x, dtype, pallas):
    """JAX's int8 probabilities and, for each AQT conv in the order of the
    forward, (operand NHWC, result NHWC, padding ((top, bottom), (left,
    right))), in fp32 numpy."""
    pads = []

    def forward(v, a):
        records, aqt = [], jax_quant_conv_fn(8)

        def record(lhs, rhs, window_strides, padding, *args, **kwargs):
            out = aqt(lhs, rhs, window_strides, padding, *args, **kwargs)
            if isinstance(padding, str):
                padding = jax.lax.padtype_to_pads(
                    lhs.shape[1:3], rhs.shape[:2], window_strides, padding)
            pads.append(tuple(map(tuple, padding)))
            records.append((lhs, out))
            return out

        conv_fn = (make_pallas_conv_fn(record, interpret=True) if pallas
                   else record)
        model = JaxUNetResNet(encoder_depth=18, dtype=dtype, conv_fn=conv_fn)
        return model.apply(v, a), records

    logits, records = jax.jit(forward)(variables, jnp.asarray(x))
    probs = np.asarray(jax.nn.sigmoid(logits.astype(jnp.float32)))
    return probs, [(np.array(lhs, np.float32), np.array(out, np.float32),
                    pad) for (lhs, out), pad in zip(records, pads)]


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _port_forced(flat, x, dtype, pallas_conv, sites):
    """The port's int8 infer form with each quantized conv's result taken
    from ``sites`` (JAX's, in order): its probabilities NHWC and, a site
    each, (the port's padded operand, JAX's padded operand, the port's
    int8 conv of JAX's operand, JAX's result), NCHW fp32."""
    cfg = port_config(flagship_config(18))
    cfg.model.quant_bits = 8
    cfg.model.pallas_conv = pallas_conv
    model = load_flax_flat(build_model(cfg.model), flat)
    model.set_compute_dtype(dtype)
    conv, seen = quant.conv2d_int8, []

    def forced(a, weight, stride=1, padding=0, groups=1):
        lhs, out, ((top, bottom), (left, right)) = sites[len(seen)]
        ph, pw = (padding, padding) if isinstance(padding, int) else padding
        theirs = F.pad(_nchw(lhs), (left, right, top, bottom))
        seen.append((F.pad(a, (pw, pw, ph, ph)).float(), theirs,
                     conv(theirs.to(a.dtype), weight, stride, 0,
                          groups).float(), _nchw(out)))
        return _nchw(out).to(a.dtype)

    quant.conv2d_int8 = forced
    try:
        with torch.no_grad():
            logits = model(torch.from_numpy(x).permute(0, 3, 1, 2),
                           infer=True)
    finally:
        quant.conv2d_int8 = conv
    return torch.sigmoid(logits.float()).permute(0, 2, 3, 1).numpy(), seen


def _ulps(got, want, mantissa):
    """|got - want| in units of the last place of ``want`` at a mantissa
    of ``mantissa`` bits (24 fp32, 8 bf16)."""
    _, exp = torch.frexp(want)
    return (got - want).abs() / torch.ldexp(torch.ones_like(want),
                                            exp - mantissa)


@pytest.mark.parametrize("pallas", [False, True], ids=["off", "on"])
def test_infer_form_matches_jax_int8(weights, pallas):
    variables, flat = weights
    rng = np.random.RandomState(2)
    size = 64 if pallas else 128       # the interpret-mode kernel is slow
    x = ((rng.rand(2, size, size, 3) - 0.45) / 0.25).astype(np.float32)
    if pallas:
        jdt, tdt, mantissa = jnp.bfloat16, torch.bfloat16, 8
        operand_tol, out_ulps, cap, mean_cap = 3e-2, 4.0, 4e-3, 6e-4
        undecidable_cap = x[..., 0].size // 10
    else:
        jdt, tdt, mantissa = jnp.float32, torch.float32, 24
        operand_tol, out_ulps, cap, mean_cap = 2e-6, 0.0, 1e-6, 1e-6
        undecidable_cap = 5
    want, sites = _jax_recorded(variables, x, jdt, pallas)
    got, seen = _port_forced(flat, x, tdt, "on" if pallas else "off", sites)
    assert len(seen) == len(sites) == (29 if pallas else 41)
    for i, (mine, theirs, on_theirs, out) in enumerate(seen):
        assert mine.shape == theirs.shape, (i, mine.shape, theirs.shape)
        assert float((mine - theirs).abs().max()) <= \
            operand_tol * float(theirs.abs().max()), i
        assert float(_ulps(on_theirs, out, mantissa).max()) <= out_ulps, i
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    delta = float(err.max())
    assert delta <= cap and float(err.mean()) <= mean_cap
    decidable = np.abs(want[..., 1] - 0.5) > delta
    assert int((~decidable).sum()) <= undecidable_cap
    np.testing.assert_array_equal((got[..., 1] > 0.5)[decidable],
                                  (want[..., 1] > 0.5)[decidable])
