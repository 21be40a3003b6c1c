"""Tests that need the card: the preprocess and bitonic sort CUDA kernels
against their plain versions, their launch counts and input checks, a
small serve step on the card against the CPU, and one bf16 train step.
Marked ``cuda``; they skip where CUDA is absent and run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``."""
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


def _sort_inputs(b, p, ties, seed=0):
    rng = np.random.RandomState(seed)
    keys = rng.randn(b, p).astype(np.float32)
    if ties:
        keys = np.round(keys * 4) / 4
    payload = ((rng.randint(0, 2, (b, p)) << 20)
               | np.arange(p)).astype(np.int32)
    return torch.from_numpy(keys), torch.from_numpy(payload)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("shape", [(1, 32768), (5, 32768), (24, 32768),
                                   (3, 1024)])
def test_sort_kernel_is_bit_identical_to_the_network(cuda, shape, ties):
    from salt_tpu_torch.ops import sort_kernel as sk
    from salt_tpu_torch.ops.bitonic import bitonic_sort_desc
    keys, payload = _sort_inputs(*shape, ties, seed=shape[0])
    keys, payload = keys.to(cuda), payload.to(cuda)
    before = sk.launches
    got_k, got_p = sk.sort_desc(keys, payload)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    want_k, want_p = bitonic_sort_desc(keys, payload)
    assert torch.equal(got_k.view(torch.int32), want_k.view(torch.int32))
    assert torch.equal(got_p, want_p)


def test_sort_kernel_refuses_bad_inputs(cuda):
    from salt_tpu_torch.ops.sort_kernel import sort_desc
    keys, payload = _sort_inputs(2, 1024, False)
    keys, payload = keys.to(cuda), payload.to(cuda)
    with pytest.raises(TypeError):
        sort_desc(keys.half(), payload)
    with pytest.raises(ValueError):
        sort_desc(keys[:, ::2], payload[:, ::2])          # 512 columns, strided
    with pytest.raises(ValueError):
        sort_desc(torch.zeros(1, 65536, device=cuda),
                  torch.zeros(1, 65536, dtype=torch.int32, device=cuda))
    big_k = torch.zeros(2, 2048, device=cuda)[:, ::2]
    big_p = torch.zeros(2, 2048, dtype=torch.int32, device=cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        sort_desc(big_k, big_p)


def test_bf16_train_step_keeps_fp32_params_that_move(cuda):
    """UNetResNet18, batch 4, bf16 compute: the loss is finite, the sort
    kernel launched once, every parameter stays fp32 and most move."""
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.ops import sort_kernel as sk
    from salt_tpu_torch.train.steps import SegmentationRunner
    cfg = default_config()
    cfg.model.encoder_depth = 18
    runner = SegmentationRunner(cfg, device=cuda)
    state = runner.init_state(0)
    imgs = _images(4, seed=3).to(cuda)
    masks = (imgs > 128).to(torch.uint8)
    before = [p.detach().clone() for p in state.model.parameters()]
    launches = sk.launches
    g = torch.Generator(device=cuda).manual_seed(0)
    loss = runner.train_step(state, imgs, masks, g)
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and sk.launches == launches + 1
    moved = total = 0
    for p, b in zip(state.model.parameters(), before):
        assert p.dtype == torch.float32
        moved += int(((p.detach() - b).abs() > 1e-5).sum())
        total += p.numel()
    assert moved > 0.9 * total, (moved, total)
