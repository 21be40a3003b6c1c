"""Tests that need the card: the preprocess CUDA kernel against its plain
version, its launch count and its input checks, and a small serve step
on the card against the CPU. Marked ``cuda``; they skip where CUDA is
absent and run on the card with ``python -m pytest -m cuda
tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _images(b, seed=0):
    return torch.from_numpy(
        (np.random.RandomState(seed).rand(b, 101, 101) * 255).astype(np.uint8))


@pytest.mark.parametrize("b", [1, 5, 48])
def test_kernel_matches_plain_version(cuda, b):
    """fp32 within atol=1e-5 of the plain version; bf16 within one bf16
    ulp of the plain fp32 result cast to bf16."""
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.ops.preprocess import preprocess_inference
    imgs = _images(b, seed=b).to(cuda)
    want = preprocess_inference(imgs)
    before = pk.launches
    got = pk.preprocess_inference_kernel(imgs, torch.float32)
    got16 = pk.preprocess_inference_kernel(imgs, torch.bfloat16)
    torch.cuda.synchronize()
    assert pk.launches == before + 2
    assert got.shape == (b, 128, 128, 3) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    want16 = want.to(torch.bfloat16).float()
    ulp = torch.abs(want16) * 2.0 ** -7 + 1e-30
    assert bool((torch.abs(got16.float() - want16) <= ulp).all())


def test_kernel_refuses_bad_inputs(cuda):
    from salt_tpu_torch.ops.preprocess_kernel import \
        preprocess_inference_kernel as k
    imgs = _images(2).to(cuda)
    with pytest.raises(TypeError):
        k(imgs.float())
    with pytest.raises(ValueError):
        k(imgs[:, :100])
    with pytest.raises(ValueError):
        k(imgs.transpose(1, 2))
    with pytest.raises(TypeError):
        k(imgs, torch.float16)


def test_tta_step_on_card_matches_cpu(cuda):
    """UNetResNet18 fp32 hflip-TTA step on the card (kernel preprocess,
    TF32 off) vs the CPU (plain preprocess): atol=1e-4."""
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.train.steps import SegmentationRunner
    cfg = default_config()
    cfg.model.encoder_depth = 18
    cfg.training.dtype = "float32"
    imgs = _images(3, seed=9)
    cpu = SegmentationRunner(cfg, device="cpu")
    want = cpu.predict_tta_step(cpu.init_model(seed=4), imgs)
    gpu = SegmentationRunner(cfg, device=cuda)
    before = pk.launches
    got = gpu.predict_tta_step(gpu.init_model(seed=4), imgs.to(cuda))
    assert pk.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
