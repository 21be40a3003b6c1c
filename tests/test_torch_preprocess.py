"""Port preprocessing (plain torch, the CUDA kernel's plain version) vs the
JAX package's ``preprocess_inference`` and its Pallas kernel in interpret
mode. Tolerance atol=1e-5: the Pallas kernel multiplies by 1/std where
the plain paths divide, so the packages agree to fp32 rounding, not bit
for bit."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from salt_tpu.ops.pallas_preprocess import preprocess_inference_pallas
from salt_tpu.ops import preprocess as jpre
from salt_tpu_torch.ops import preprocess as tpre
from salt_tpu_torch.ops import preprocess_kernel

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


def _images(b, seed):
    return (np.random.RandomState(seed).rand(b, 101, 101) * 255).astype(np.uint8)


@pytest.mark.parametrize("b", [8, 5], ids=["batch8", "ragged5"])
def test_plain_matches_jax_and_pallas_interpret(b):
    imgs = _images(b, seed=b)
    got = tpre.preprocess_inference(torch.from_numpy(imgs)).numpy()
    want = np.asarray(jpre.preprocess_inference(imgs, pad_method="edge",
                                                out_dtype=jnp.float32))
    pallas = np.asarray(preprocess_inference_pallas(
        imgs, out_dtype=jnp.float32, interpret=True))
    assert got.shape == (b, 128, 128, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)


@pytest.mark.parametrize("method", ["edge", "reflect", "zero"])
def test_pad_crop_match_jax(method):
    x = np.random.RandomState(0).rand(3, 101, 101).astype(np.float32)
    got = tpre.pad_to_divisor(torch.from_numpy(x), 64, method).numpy()
    want = np.asarray(jpre.pad_to_divisor(x, 64, method))
    np.testing.assert_array_equal(got, want)
    back = tpre.crop_to_target(torch.from_numpy(got), (101, 101)).numpy()
    np.testing.assert_array_equal(back, x)


def test_pad_split_is_13_14_14_13():
    assert tpre.get_crop_pad_sequence(27, 27) == (13, 13, 14, 14)
    x = torch.zeros(1, 101, 101)
    x[0, 0, 0] = 1.0
    padded = tpre.pad_to_divisor(x, 64, "zero")
    assert padded[0, 13, 14] == 1.0 and padded.sum() == 1.0


@pytest.mark.parametrize("src,dst", [(101, 128), (128, 101)],
                         ids=["up", "down"])
def test_resize_matches_jax_image_resize(src, dst):
    """loader_mode='resize' geometry: jax.image.resize 'linear' (which
    widens the filter when shrinking) vs torch antialiased bilinear.
    atol=1e-5 (fp32 rounding of two weight computations)."""
    x = np.random.RandomState(1).rand(2, 2, src, src).astype(np.float32)
    got = tpre.resize_hw(torch.from_numpy(x), (dst, dst)).numpy()
    want = np.asarray(jpre.resize_hw(x, (dst, dst)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_depth_channels_match_jax():
    g = np.random.RandomState(2).randn(2, 128, 128).astype(np.float32)
    got = tpre.add_depth_channels(torch.from_numpy(g)).numpy()
    want = np.asarray(jpre.add_depth_channels(g))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_kernel_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor goes through the plain version (no launch counted);
    the bf16 output is the plain fp32 result cast to bf16."""
    imgs = torch.from_numpy(_images(3, seed=4))
    before = preprocess_kernel.launches
    got = preprocess_kernel.preprocess_inference_kernel(imgs, torch.float32)
    got16 = preprocess_kernel.preprocess_inference_kernel(imgs)
    want = tpre.preprocess_inference(imgs)
    assert preprocess_kernel.launches == before
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(got16, want.to(torch.bfloat16), atol=0, rtol=0)


def test_runner_routes_production_geometry_through_kernel_wrapper(monkeypatch):
    """_infer_inputs sends resize_and_pad/edge/101->128 uint8 batches to
    the kernel wrapper (its plain version on the CPU) and returns the
    channels_last NCHW view; other geometries take the plain ops."""
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.train.steps import SegmentationRunner

    calls = []
    real = preprocess_kernel.preprocess_inference_kernel

    def spy(x, out_dtype=torch.bfloat16):
        calls.append((tuple(x.shape), out_dtype))
        return real(x, out_dtype)

    monkeypatch.setattr("salt_tpu_torch.train.steps."
                        "preprocess_inference_kernel", spy)
    imgs = torch.from_numpy(_images(2, seed=5))
    cfg = default_config()
    x = SegmentationRunner(cfg, device="cpu")._infer_inputs(imgs)
    assert calls == [((2, 101, 101), torch.bfloat16)]
    assert x.shape == (2, 3, 128, 128) and x.dtype == torch.bfloat16
    assert x.is_contiguous(memory_format=torch.channels_last)

    cfg.execution.loader_mode = "resize"
    cfg.training.dtype = "float32"
    x = SegmentationRunner(cfg, device="cpu")._infer_inputs(imgs)
    assert len(calls) == 1
    want = np.asarray(jpre.preprocess_resize_mode(imgs.numpy()))
    np.testing.assert_allclose(x.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=0)
