"""The port's 3x3 conv (``ops.conv_pair``, ``ops.conv_kernel``) against the
JAX package's pair-packed Pallas conv (``salt_tpu/ops/pallas_conv.py``),
run in interpret mode on the CPU as tests/test_pallas_conv.py runs it.

Inputs come from numpy seeds; the port's NCHW / OIHW tensors are the JAX
package's NHWC / HWIO arrays permuted. fp32 at 2e-4 (the JAX kernel's own
tolerance, tests/test_pallas_conv.py:28); bf16 through the dispatch at
3e-2 (:59); every ineligible call bit-equal to ``F.conv2d``."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from salt_tpu.ops.pallas_conv import conv3x3_pair as jax_conv3x3_pair
from salt_tpu.ops.pallas_conv import make_pallas_conv_fn
from salt_tpu_torch.ops import conv_kernel
from salt_tpu_torch.ops.conv_pair import (conv3x3_pair, conv3x3_packed,
                                         make_conv_fn, pack_weight, route)

DN = ("NHWC", "HWIO", "NHWC")


def _arrays(b, hx, wx, c, seed, scale=0.1):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, hx, wx, c).astype(np.float32)
    w = (rng.randn(3, 3, c, 64) * scale).astype(np.float32)
    return x, w


def _to_port(x, w, dtype=torch.float32):
    """NHWC / HWIO numpy -> NCHW (channels_last memory) / OIHW tensors."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous().to(dtype)
    return xt, wt


def _nhwc(y):
    return y.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("halo", [False, True], ids=["same", "halo"])
@pytest.mark.parametrize("c", [32, 64, 320])
def test_plain_matches_jax_kernel_fp32(c, halo):
    x, w = _arrays(1, 34 if halo else 32, 34 if halo else 32, c, seed=c,
                   scale=0.05 if c == 320 else 0.1)
    want = np.asarray(jax_conv3x3_pair(jnp.asarray(x), jnp.asarray(w),
                                       halo=halo, interpret=True))
    got = _nhwc(conv3x3_pair(*_to_port(x, w), halo=halo))
    assert got.shape == want.shape == (1, 32, 32, 64)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,h,w,c,halo", [
    *[(1, 32, 32, c, halo) for c in (16, 32, 64, 320)
      for halo in (False, True)],
    (2, 10, 34, 80, False)],
    ids=lambda v: str(v))
def test_packed_layout_matches_jax_kernel_fp32(b, h, w, c, halo):
    """The conv from the CUDA kernel's packed weight layout and its
    zero-filled 64-channel chunks (C 16, 32: one partial chunk; 320: five;
    80 on a ragged 10 x 34 output: a full and a partial one), held against
    the JAX kernel at its own 2e-4."""
    x, wt = _arrays(b, h + 2 * halo, w + 2 * halo, c, seed=c + h,
                    scale=0.05 if c > 64 else 0.1)
    want = np.asarray(jax_conv3x3_pair(jnp.asarray(x), jnp.asarray(wt),
                                       halo=halo, interpret=True))
    xt, wp = _to_port(x, wt)
    packed = pack_weight(wp)
    assert packed.shape == (64, 3, 3, c) and packed.is_contiguous()
    got = _nhwc(conv3x3_packed(xt, packed, halo=halo))
    assert got.shape == want.shape == (b, h, w, 64)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("padding,halo", [("SAME", False), ("VALID", True)])
def test_dispatch_matches_jax_dispatch_bf16(padding, halo):
    """The eligible bf16 call through both dispatches: JAX's reaches its
    Pallas kernel, the port's the kernel wrapper (its plain version on
    the CPU)."""
    size = 34 if halo else 32
    x, w = _arrays(1, size, size, 64, seed=5)
    xj = jnp.asarray(x, jnp.bfloat16)
    wj = jnp.asarray(w, jnp.bfloat16)
    import jax
    dn = jax.lax.conv_dimension_numbers(xj.shape, wj.shape, DN)
    want = np.asarray(make_pallas_conv_fn(interpret=True)(
        xj, wj, (1, 1), padding, dimension_numbers=dn), np.float32)
    xt, wt = _to_port(x, w, torch.bfloat16)
    assert route(xt, wt, None, 1, 0 if halo else 1, 1, 1) is halo
    got = _nhwc(make_conv_fn()(xt, wt, None, 1, 0 if halo else 1))
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("case", ["kernel5", "stride2", "out128", "small",
                                  "f32", "c32", "odd_w", "bias", "dilation",
                                  "padding2"])
def test_ineligible_calls_are_exactly_f_conv2d(case, monkeypatch):
    """The cases of tests/test_pallas_conv.py::test_conv_fn_fallback_is_exact
    and the other arguments ``F.conv2d`` takes: bit-equal, and the kernel
    is never called."""
    def refuse(*a, **k):
        raise AssertionError("routed to the kernel")

    monkeypatch.setattr(conv_kernel, "conv3x3_pair_kernel", refuse)
    b, h, w, c, f, k = 1, 32, 32, 64, 64, 3
    dtype = torch.bfloat16
    kw = dict(stride=1, padding=k // 2, dilation=1)
    bias = None
    if case == "kernel5":
        k = 5
        kw["padding"] = 2
    elif case == "stride2":
        kw["stride"] = 2
    elif case == "out128":
        f = 128
    elif case == "small":
        h = w = 16
    elif case == "f32":
        dtype = torch.float32
    elif case == "c32":
        c = 32
    elif case == "odd_w":
        w = 33
    elif case == "bias":
        bias = torch.ones(f, dtype=dtype)
    elif case == "dilation":
        kw.update(dilation=2, padding=2)
    elif case == "padding2":
        kw["padding"] = 2
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(dtype)
    wt = torch.from_numpy((rng.randn(f, c, k, k) * 0.1).astype(np.float32)
                          ).to(dtype)
    if bias is not None:
        bias = bias.to(dtype)
    got = make_conv_fn()(x, wt, bias, **kw)
    want = F.conv2d(x, wt, bias, **kw)
    assert torch.equal(got, want)


def test_autocast_routes_fp32_calls_as_bf16(monkeypatch):
    """Under autocast the dispatch casts input and weight to the autocast
    dtype before its rules, as ``F.conv2d`` would: validation during
    training routes the same convs as bf16 serving, with the same
    result."""
    seen = []
    real = conv_kernel.conv3x3_pair_kernel

    def spy(x, w, halo=False):
        seen.append((x.dtype, w.dtype, halo))
        return real(x, w, halo)

    monkeypatch.setattr(conv_kernel, "conv3x3_pair_kernel", spy)
    x, w = _arrays(2, 32, 32, 64, seed=3)
    xt, wt = _to_port(x, w)
    conv = make_conv_fn()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = conv(xt, wt, None, 1, 1)
    want = conv(xt.to(torch.bfloat16), wt.to(torch.bfloat16), None, 1, 1)
    assert seen == [(torch.bfloat16, torch.bfloat16, False)] * 2
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("mode", ["off", "on", "auto"])
def test_registry_conv_fn_per_mode(mode, monkeypatch):
    """``model.pallas_conv``: "off" is ``F.conv2d`` itself; "on" and "auto"
    (the kernel on any device but a CPU, as in the JAX registry) send an
    eligible bf16 call to the kernel wrapper, which takes its plain
    version on the CPU."""
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.models.registry import infer_conv_fn
    cfg = default_config().model
    cfg.pallas_conv = mode
    seen = []
    real = conv_kernel.conv3x3_pair_kernel

    def spy(x, w, halo=False):
        seen.append(halo)
        return real(x, w, halo)

    monkeypatch.setattr(conv_kernel, "conv3x3_pair_kernel", spy)
    conv = infer_conv_fn(cfg)
    xt, wt = _to_port(*_arrays(1, 32, 32, 64, seed=4), torch.bfloat16)
    got = conv(xt, wt, None, 1, 1)
    if mode == "off":
        assert conv is F.conv2d and seen == []
    else:
        assert seen == [False]
        assert torch.equal(got, conv3x3_pair(xt, wt))


def test_wrapper_takes_the_plain_version_on_the_cpu_and_refuses():
    x, w = _arrays(1, 32, 32, 64, seed=2)
    xt, wt = _to_port(x, w, torch.bfloat16)
    before = conv_kernel.launches
    got = conv_kernel.conv3x3_pair_kernel(xt, wt)
    assert torch.equal(got, conv3x3_pair(xt, wt))
    assert got.shape == (1, 64, 32, 32) and got.dtype == torch.bfloat16
    with pytest.raises(RuntimeError, match="inference-only"):
        conv_kernel.conv3x3_pair_kernel(xt.float().requires_grad_(),
                                        wt.float())
    with pytest.raises(ValueError, match="64"):
        conv_kernel.conv3x3_pair_kernel(xt, wt[:32])
    with pytest.raises(ValueError, match="device"):
        conv_kernel.conv3x3_pair_kernel(xt.to("meta"), wt.to("meta"))
    with torch.no_grad():
        out = conv_kernel.conv3x3_pair_kernel(xt[:0], wt)
    assert out.shape == (0, 64, 32, 32)
    assert conv_kernel.launches == before
