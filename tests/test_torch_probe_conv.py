"""The port's conv probe kernels (``ops.conv64p_kernel``,
``ops.conv128_kernel``; their plain versions in ``ops.probe_conv``)
against the JAX probes ``tools/pallas_conv.py::make_conv64p_kernel`` /
``make_conv128_kernel`` and ``tools/pallas_conv2.py::make_conv64p_v2``,
run on the CPU in Pallas interpret mode (``force_tpu_interpret_mode``).

Inputs come from numpy seeds in the probes' own layouts, so the tensors
compare directly. fp32 within 2e-4 (tests/test_pallas_conv.py:28); bf16
within one bf16 ulp plus 2 K 2^-24 sum|x||w| (``torch_parity.bf16_ulp_rule``:
the same exact products summed in fp32 in another order, rounded once);
int8 bit for bit (every partial sum is an integer below 2^24). The input
columns the probes never read hold NaN."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from torch_parity import bf16_ulp_rule, load_tool

from salt_tpu_torch.ops import conv64p_kernel, conv128_kernel, conv_valid
from salt_tpu_torch.ops.probe_conv import (WPAD, WPAD2, conv64p_plain,
                                           conv128_plain, pack_pair_weights,
                                           pack_pairs, valid_conv_plain)

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

B, H, W = 2, 32, 32

pallas_conv = load_tool("pallas_conv")
pallas_conv2 = load_tool("pallas_conv2")


def _jax(factory, *args, **kw):
    """Build and run a JAX probe kernel in interpret mode."""
    def run(*operands):
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(factory(*args, **kw)(*operands), np.float32)
    return run


def _packed_inputs(seed, dense_weights=False):
    """fp32 x_packed [B, H+2, (W+16)/2, 128] (pixels past W+1 NaN) and
    w_packed [768, 128]: packed from a [3, 3, 64, 64] kernel, or random in
    every slot (``dense_weights``: the structural slots nonzero)."""
    rng = np.random.RandomState(seed)
    x = np.full((B, H + 2, W + WPAD2, 64), np.nan, np.float32)
    x[:, :, :W + 2] = rng.randn(B, H + 2, W + 2, 64)
    w = (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32)
    wp = (rng.randn(768, 128) * 0.05).astype(np.float32) if dense_weights \
        else pack_pair_weights(w)
    return pack_pairs(x), wp, x, w


def _terms64(xp, wp):
    """sum |x||w| of each output of the pair-packed product (fp32)."""
    x = torch.from_numpy(np.nan_to_num(np.abs(xp)))
    return conv64p_plain(x, torch.from_numpy(np.abs(wp)), H, W).numpy()


@pytest.mark.parametrize("dense", [False, True],
                         ids=["packed", "structural_slots_nonzero"])
@pytest.mark.parametrize("tile_h", [16, 32])
def test_conv64p_matches_jax_fp32(tile_h, dense):
    """Row 5 in fp32, all 768 weight rows honoured."""
    xp, wp, _, _ = _packed_inputs(seed=tile_h + dense, dense_weights=dense)
    want = _jax(pallas_conv.make_conv64p_kernel, tile_h, H, W)(
        jnp.asarray(xp), jnp.asarray(wp))
    got = conv64p_kernel.make_conv64p_kernel(tile_h, H, W)(
        torch.from_numpy(xp), torch.from_numpy(wp))
    assert got.dtype == torch.float32 and got.shape == (B, H, W // 2, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    if dense:          # zeroing one structural slot moves the result
        zeroed = wp.copy()
        zeroed[0:64, 64:] = 0          # ky 0, pixel 0 of the odd output
        moved = conv64p_kernel.make_conv64p_kernel(tile_h, H, W)(
            torch.from_numpy(xp), torch.from_numpy(zeroed))
        assert not torch.allclose(moved, got, rtol=2e-4, atol=2e-4)


def test_pair_packing_is_the_valid_conv():
    """conv64p of pack_pairs / pack_pair_weights is the VALID 3x3 conv of
    the unpacked input (conv128_plain at C = 64), fp32 within 2e-4."""
    xp, wp, x, w = _packed_inputs(seed=3)
    got = conv64p_plain(torch.from_numpy(xp), torch.from_numpy(wp), H, W)
    want = conv128_plain(torch.from_numpy(x), torch.from_numpy(
        w.reshape(9 * 64, 64)), H, W)
    np.testing.assert_allclose(got.reshape(B, H, W, 64).numpy(),
                               want.numpy(), rtol=2e-4, atol=2e-4)


def test_valid_conv_plain_is_the_pair_packed_conv():
    """Row 5 as the VALID 3x2 conv 128 -> 128 over the packed columns (K
    index (ky*2 + q)*128 + c), the function ``csrc/conv_valid.cu``
    computes: equal to ``conv64p_plain`` within 1e-6 relative and to the
    JAX row-5 kernel within 2e-4, fp32, every weight slot nonzero and NaN
    in the packed columns past W/2 + 1."""
    xp, wp, _, _ = _packed_inputs(seed=13, dense_weights=True)
    x, w = torch.from_numpy(xp), torch.from_numpy(wp)
    got = valid_conv_plain(x, w, 3, 2, H, W // 2)
    assert got.shape == (B, H, W // 2, 128) and torch.isfinite(got).all()
    want = conv64p_plain(x, w, H, W)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale
    jax_out = _jax(pallas_conv.make_conv64p_kernel, 16, H, W)(
        jnp.asarray(xp), jnp.asarray(wp))
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kw,c,f", [(3, 128, 64), (2, 128, 128), (3, 64, 192)])
def test_valid_conv_plain_matches_conv2d(kw, c, f):
    """valid_conv_plain against ``F.conv2d`` of the same fp32 operands
    (HWIO weights flattened in K order), within 2e-4; the input columns
    past w_out + kw - 1 hold NaN and are never read."""
    rng = np.random.RandomState(kw + c + f)
    h, w_out = 6, 10
    x = np.full((2, h + 2, w_out + kw + 3, c), np.nan, np.float32)
    x[:, :, :w_out + kw - 1] = rng.randn(2, h + 2, w_out + kw - 1, c)
    w = (rng.randn(3, kw, c, f) / np.sqrt(3 * kw * c)).astype(np.float32)
    got = valid_conv_plain(torch.from_numpy(x),
                           torch.from_numpy(w.reshape(3 * kw * c, f)), 3, kw,
                           h, w_out)
    want = torch.nn.functional.conv2d(
        torch.from_numpy(x[:, :, :w_out + kw - 1]).permute(0, 3, 1, 2),
        torch.from_numpy(w).permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_conv64p_matches_jax_bf16():
    xp, wp, _, _ = _packed_inputs(seed=5, dense_weights=True)
    xb, wb = (torch.from_numpy(np.nan_to_num(xp)).bfloat16(),
              torch.from_numpy(wp).bfloat16())
    want = _jax(pallas_conv.make_conv64p_kernel, 16, H, W)(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16),
        jnp.asarray(wb.float().numpy(), jnp.bfloat16))
    got = conv64p_kernel.make_conv64p_kernel(16, H, W)(xb, wb)
    assert got.dtype == torch.bfloat16
    terms = _terms64(xb.float().numpy(), wb.float().numpy())
    assert bf16_ulp_rule(got.float().numpy(), want, terms, 768) <= 1.0


@pytest.mark.parametrize("shift,dots,db", [
    ("roll", "concat", False), ("hoist", "split", False),
    ("slice", "split", False), ("hoist", "split", True),
    ("hoist", "concat", True)])
def test_conv64p_v2_matches_jax_bf16(shift, dots, db):
    """Row 7 in bf16: every Mosaic variant is one function; the port's
    ``db`` flag only changes how the card stages the input."""
    xp, wp, _, _ = _packed_inputs(seed=7, dense_weights=True)
    xb = torch.from_numpy(np.nan_to_num(xp)).bfloat16()
    wb = torch.from_numpy(wp).bfloat16()
    want = _jax(pallas_conv2.make_conv64p_v2, 16, H, W, shift=shift,
                dots=dots, db=db)(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16),
        jnp.asarray(wb.float().numpy(), jnp.bfloat16))
    got = conv64p_kernel.make_conv64p_v2(16, H, W, db=db)(xb, wb)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, W // 2, 128)
    terms = _terms64(xb.float().numpy(), wb.float().numpy())
    assert bf16_ulp_rule(got.float().numpy(), want, terms, 768) <= 1.0


@pytest.mark.parametrize("dots", ["concat", "split"])
@pytest.mark.parametrize("db", [False, True], ids=["db_off", "db_on"])
def test_conv64p_v2_int8_is_bit_exact(dots, db):
    """int8 x int8 -> bf16 of the int32 sum, bit for bit, with every weight
    slot nonzero and the full int8 range."""
    rng = np.random.RandomState(11)
    xq = rng.randint(-127, 128, (B, H + 2, (W + WPAD2) // 2, 128)
                     ).astype(np.int8)
    wq = rng.randint(-128, 128, (768, 128)).astype(np.int8)
    want = _jax(pallas_conv2.make_conv64p_v2, 32, H, W, dots=dots, db=db,
                int8=True)(jnp.asarray(xq), jnp.asarray(wq))
    got = conv64p_kernel.make_conv64p_v2(32, H, W, db=db, int8=True)(
        torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)
    exact = xq.astype(np.float64)
    cols = np.concatenate([exact[:, ky:ky + H, q:q + W // 2]
                           for ky in range(3) for q in range(2)], axis=-1)
    ints = cols @ wq.astype(np.float64)
    assert np.array_equal(
        got.float().numpy(),
        torch.from_numpy(ints.astype(np.float32)).bfloat16().float().numpy())


def _int8_packed(seed):
    """Full-range int8 x_packed (127 in the packed columns past W/2, which
    no output reads) and w_packed (-128 included)."""
    rng = np.random.RandomState(seed)
    xq = rng.randint(-128, 128, (B, H + 2, (W + WPAD2) // 2, 128)
                     ).astype(np.int8)
    xq[:, :, W // 2 + 1:] = 127
    wq = rng.randint(-128, 128, (768, 128)).astype(np.int8)
    wq[0, :64] = -128
    return xq, wq


def test_conv64p_v2_int8_cpu_path_is_the_jax_kernel():
    """Row 7's CPU path is ``valid_conv_plain`` with KW 2 over the packed
    columns, the function its kernel computes: bit for bit equal to it and
    to the JAX row-7 int8 kernel in interpret mode, with 127 in the
    columns past W/2 + 1."""
    xq, wq = _int8_packed(seed=17)
    want = _jax(pallas_conv2.make_conv64p_v2, 32, H, W, db=True, int8=True)(
        jnp.asarray(xq), jnp.asarray(wq))
    x, w = torch.from_numpy(xq), torch.from_numpy(wq)
    got = conv64p_kernel.make_conv64p_v2(32, H, W, db=True, int8=True)(x, w)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, W // 2, 128)
    assert torch.equal(got, valid_conv_plain(x, w, 3, 2, H, W // 2))
    assert np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("db", [False, True], ids=["db_off", "db_on"])
def test_conv64p_v2_and_row5_are_one_function_bf16(db):
    """Rows 7 and 5 give identical bf16 outputs (one kernel, one plain
    version), finite with NaN in the packed columns past W/2 + 1."""
    xp, wp, _, _ = _packed_inputs(seed=19, dense_weights=True)
    xb, wb = torch.from_numpy(xp).bfloat16(), torch.from_numpy(wp).bfloat16()
    got7 = conv64p_kernel.make_conv64p_v2(16, H, W, db=db)(xb, wb)
    got5 = conv64p_kernel.make_conv64p_kernel(16, H, W)(xb, wb)
    assert got7.dtype == torch.bfloat16 and bool(torch.isfinite(got7).all())
    assert torch.equal(got7, got5)


def test_kmajor_weights_product_is_the_conv():
    """``conv_valid.kmajor_weights``, the int8 kernel's weight operand
    [F, K] (wt[f, k] = w[k, f]): the taps' windows times it, summed over
    k as the kernel sums, reproduce ``valid_conv_plain`` bit for bit."""
    xq, wq = _int8_packed(seed=23)
    x, w = torch.from_numpy(xq), torch.from_numpy(wq)
    wt = conv_valid.kmajor_weights(w)
    assert wt.shape == (128, 768) and wt.is_contiguous()
    assert torch.equal(wt, w.t())
    cols = torch.cat([x[:, ky:ky + H, q:q + W // 2].double()
                      for ky in range(3) for q in range(2)], dim=-1)
    got = torch.einsum("bhpk,fk->bhpf", cols, wt.double())
    want = valid_conv_plain(x, w, 3, 2, H, W // 2)
    assert torch.equal(got.float().bfloat16(), want)


def _conv128_inputs(c, f, seed):
    rng = np.random.RandomState(seed)
    x = np.full((B, H + 2, W + WPAD, c), np.nan, np.float32)
    x[:, :, :W + 2] = rng.randn(B, H + 2, W + 2, c)
    w = (rng.randn(9 * c, f) / np.sqrt(9 * c)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("tile_h,f", [(16, 128), (32, 64), (8, 128)])
def test_conv128_matches_jax_fp32(tile_h, f):
    """Row 4 in fp32; columns W+2 .. W+7 hold NaN and are never read."""
    x, w = _conv128_inputs(128, f, seed=tile_h + f)
    want = _jax(pallas_conv.make_conv128_kernel, tile_h, H, W, 128, f)(
        jnp.asarray(x), jnp.asarray(w))
    got = conv128_kernel.make_conv128_kernel(tile_h, H, W, 128, f)(
        torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (B, H, W, f) and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_conv128_matches_jax_bf16():
    """K = 9C = 2304 at C = 256."""
    x, w = _conv128_inputs(256, 128, seed=2)
    xb = torch.from_numpy(np.nan_to_num(x)).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    want = _jax(pallas_conv.make_conv128_kernel, 16, H, W, 256, 128)(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16),
        jnp.asarray(wb.float().numpy(), jnp.bfloat16))
    got = conv128_kernel.make_conv128_kernel(16, H, W, 256, 128)(xb, wb)
    assert got.dtype == torch.bfloat16
    terms = conv128_plain(xb.float().abs(), wb.float().abs(), H, W).numpy()
    assert bf16_ulp_rule(got.float().numpy(), want, terms, 9 * 256) <= 1.0


def test_probe_convs_refuse_what_they_cannot_compute():
    """The tail rows of H % tile_h would be undefined in the Pallas probes:
    the port raises instead, and on every other input its kernel does not
    take; CPU calls launch nothing."""
    before = (conv64p_kernel.launches, conv64p_kernel.launches_v2,
              conv128_kernel.launches)
    with pytest.raises(ValueError, match="tile_h"):
        conv64p_kernel.make_conv64p_kernel(12, H, W)
    with pytest.raises(ValueError, match="tile_h"):
        conv64p_kernel.make_conv64p_v2(64, 96, W, db=True)
    with pytest.raises(ValueError, match="tile_h"):
        conv128_kernel.make_conv128_kernel(24, H, W, 128, 128)
    with pytest.raises(ValueError, match="C = 64"):
        conv64p_kernel.make_conv64p_kernel(16, H, W, C=32)
    with pytest.raises(ValueError, match="even W"):
        conv64p_kernel.make_conv64p_v2(16, H, 33)
    with pytest.raises(ValueError, match="multiple of 128"):
        conv128_kernel.make_conv128_kernel(16, H, W, 64, 128)
    with pytest.raises(ValueError, match="multiple of 64"):
        conv128_kernel.make_conv128_kernel(16, H, W, 128, 96)
    xp, wp, _, _ = _packed_inputs(seed=1)
    conv = conv64p_kernel.make_conv64p_v2(16, H, W)
    with pytest.raises(TypeError):
        conv(torch.from_numpy(xp), torch.from_numpy(wp))        # fp32
    with pytest.raises(TypeError):
        conv64p_kernel.make_conv64p_v2(16, H, W, int8=True)(
            torch.from_numpy(xp).bfloat16(), torch.from_numpy(wp).bfloat16())
    with pytest.raises(ValueError, match="expected"):
        conv(torch.from_numpy(xp[:, 1:]).bfloat16(),
             torch.from_numpy(wp).bfloat16())
    with pytest.raises(ValueError, match="device"):
        conv(torch.from_numpy(xp).bfloat16().to("meta"),
             torch.from_numpy(wp).bfloat16().to("meta"))
    with pytest.raises(RuntimeError, match="inference-only"):
        conv64p_kernel.make_conv64p_kernel(16, H, W)(
            torch.from_numpy(xp).requires_grad_(), torch.from_numpy(wp))
    assert (conv64p_kernel.launches, conv64p_kernel.launches_v2,
            conv128_kernel.launches) == before
