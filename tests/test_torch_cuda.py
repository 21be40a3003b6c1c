"""Tests that need the card: the preprocess, bitonic sort and 3x3 conv
CUDA kernels and the conv and matmul probe kernels against their plain
versions, their launch counts and input checks, a small serve step on the
card against the CPU, a predict step through the conv kernel, and one
bf16 train step.
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


def _conv_inputs(b, c, hx, wx, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, hx, wx, c).astype(np.float32))
    w = torch.from_numpy((rng.randn(64, c, 3, 3) / np.sqrt(9 * c))
                         .astype(np.float32))
    return x.permute(0, 3, 1, 2).to(torch.bfloat16), w.to(torch.bfloat16)


@pytest.mark.parametrize("b,c,hx,wx,halo", [
    (2, 64, 64, 64, False), (2, 64, 66, 66, True), (1, 64, 32, 32, False),
    (1, 32, 40, 48, False), (1, 320, 64, 64, False), (3, 64, 130, 130, True),
    (1, 16, 33, 70, False)])
def test_conv_kernel_matches_plain_version(cuda, b, c, hx, wx, halo):
    """bf16 within one bf16 ulp of the plain version (fp32 conv with TF32
    off, rounded to bf16), plus 2 K 2^-24 sum|x||w| (K = 9 C) where
    cancellation leaves a value tiny next to its terms: both sum the same
    exact products in fp32, in another order."""
    from salt_tpu_torch.ops import conv_kernel as ck
    from salt_tpu_torch.ops.conv_pair import conv3x3_pair
    x, w = _conv_inputs(b, c, hx, wx, seed=c + hx)
    x = x.to(cuda).contiguous(memory_format=torch.channels_last)
    w = w.to(cuda)
    before = ck.launches
    with torch.no_grad():
        got = ck.conv3x3_pair_kernel(x, w, halo=halo)
        torch.cuda.synchronize()
        want = conv3x3_pair(x, w, halo=halo).float()
        terms = conv3x3_pair(x.float().abs(), w.float().abs(), halo=halo)
    assert ck.launches == before + 1
    h, wd = (hx - 2, wx - 2) if halo else (hx, wx)
    assert got.shape == (b, 64, h, wd) and got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    _, exp = torch.frexp(want)
    ulp = torch.where(want == 0, torch.zeros_like(want),
                      torch.ldexp(torch.ones_like(want), exp - 8))
    tol = ulp + 2 * 9 * c * 2.0 ** -24 * terms
    assert bool(((got.float() - want).abs() <= tol).all())


def test_conv_kernel_refuses_bad_inputs(cuda):
    from salt_tpu_torch.ops import conv_kernel as ck
    x, w = _conv_inputs(1, 64, 32, 32)
    x = x.to(cuda).contiguous(memory_format=torch.channels_last)
    w = w.to(cuda)
    before = ck.launches
    with pytest.raises(TypeError):
        ck.conv3x3_pair_kernel(x.float(), w.float())
    with pytest.raises(ValueError, match="channels_last"):
        ck.conv3x3_pair_kernel(x.contiguous(), w)
    xs, ws = _conv_inputs(1, 24, 32, 32)
    with pytest.raises(ValueError, match="multiple of 16"):
        ck.conv3x3_pair_kernel(
            xs.to(cuda).contiguous(memory_format=torch.channels_last),
            ws.to(cuda))
    with pytest.raises(RuntimeError, match="inference-only"):
        ck.conv3x3_pair_kernel(x.float().requires_grad_(), w.float())
    assert ck.launches == before


@pytest.mark.parametrize("pad_mode", ["same", "reference"])
def test_predict_step_with_conv_kernel(cuda, pad_mode):
    """UNetResNet18, bf16 hflip-TTA predict step with model.pallas_conv
    "on": the kernel launches 12 times per forward (4 encoder, 3 decoder,
    5 head convs) and the probabilities stay within 2e-2 of "off" (bf16
    rounding of a few convs in another order)."""
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.ops import conv_kernel as ck
    from salt_tpu_torch.train.steps import SegmentationRunner
    probs = {}
    for mode in ("off", "on"):
        cfg = default_config()
        cfg.model.encoder_depth = 18
        cfg.model.conv_pad_mode = pad_mode
        cfg.model.pallas_conv = mode
        runner = SegmentationRunner(cfg, device=cuda)
        model = runner.init_model(seed=4)
        before = ck.launches
        probs[mode] = runner.predict_tta_step(model, _images(4, 5).to(cuda))
        torch.cuda.synchronize()
        assert ck.launches - before == (12 if mode == "on" else 0)
    assert bool(torch.isfinite(probs["on"]).all())
    torch.testing.assert_close(probs["on"], probs["off"], atol=2e-2, rtol=0)


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


def _ulp_rule(got, want, terms, k):
    """The largest |got - want| over one bf16 ulp of ``want`` plus
    2 K 2^-24 ``terms`` (sum |x||w| of each output); <= 1 passes."""
    want = want.float()
    _, exp = torch.frexp(want)
    ulp = torch.where(want == 0, torch.zeros_like(want),
                      torch.ldexp(torch.ones_like(want), exp - 8))
    tol = ulp + 2 * k * 2.0 ** -24 * terms.float()
    return float(((got.float() - want).abs() / tol.clamp_min(1e-30)).max())


def _packed(b, h, w, seed, dtype=torch.bfloat16):
    """x_packed [b, h+2, (w+16)/2, 128] and a w_packed [768, 128] random in
    every slot (the structural ones included)."""
    rng = np.random.RandomState(seed)
    shape = (b, h + 2, (w + 16) // 2, 128)
    if dtype == torch.int8:
        return (torch.from_numpy(rng.randint(-127, 128, shape)
                                 .astype(np.int8)),
                torch.from_numpy(rng.randint(-128, 128, (768, 128))
                                 .astype(np.int8)))
    return (torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dtype),
            torch.from_numpy((rng.randn(768, 128) * 0.05).astype(np.float32)
                             ).to(dtype))


@pytest.mark.parametrize("b,h,w,tile_h,db", [
    (2, 32, 32, 16, False), (1, 64, 128, 32, True), (3, 8, 20, 4, True),
    (2, 128, 128, 64, False)])
def test_conv64p_kernels_match_plain_version(cuda, b, h, w, tile_h, db):
    """Rows 5 and 7 in bf16 within one bf16 ulp plus 2 K 2^-24 sum|x||w|
    (K = 768) of the plain version; (3, 8, 20, 4) has 40-pair grid tiles,
    so the kernel's 128-row tiles are ragged there."""
    from salt_tpu_torch.ops import conv64p_kernel as k
    from salt_tpu_torch.ops.probe_conv import conv64p_plain
    x, wp = (t.to(cuda) for t in _packed(b, h, w, seed=h + w))
    before = (k.launches, k.launches_v2)
    with torch.no_grad():
        got5 = k.make_conv64p_kernel(tile_h, h, w)(x, wp)
        got7 = k.make_conv64p_v2(tile_h, h, w, db=db)(x, wp)
        torch.cuda.synchronize()
        want = conv64p_plain(x, wp, h, w)
        terms = conv64p_plain(x.float().abs(), wp.float().abs(), h, w)
    assert (k.launches, k.launches_v2) == (before[0] + 1, before[1] + 1)
    for got in (got5, got7):
        assert got.shape == (b, h, w // 2, 128) and got.dtype == torch.bfloat16
        assert _ulp_rule(got, want, terms, 768) <= 1.0


@pytest.mark.parametrize("db", [False, True], ids=["db_off", "db_on"])
def test_conv64p_int8_kernel_is_bit_exact(cuda, db):
    from salt_tpu_torch.ops import conv64p_kernel as k
    from salt_tpu_torch.ops.probe_conv import conv64p_plain
    x, wp = (t.to(cuda) for t in _packed(2, 64, 64, seed=3, dtype=torch.int8))
    with torch.no_grad():
        got = k.make_conv64p_v2(32, 64, 64, db=db, int8=True)(x, wp)
        torch.cuda.synchronize()
    want = conv64p_plain(x, wp, 64, 64)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,h,w,c,f,tile_h", [
    (2, 32, 32, 128, 128, 16), (1, 16, 24, 256, 64, 8),
    (1, 8, 40, 128, 192, 8)])
def test_conv128_kernel_matches_plain_version(cuda, b, h, w, c, f, tile_h):
    """Row 4 in bf16, K = 9C; the input columns past W+1 hold NaN."""
    from salt_tpu_torch.ops import conv128_kernel as k
    from salt_tpu_torch.ops.probe_conv import conv128_plain
    rng = np.random.RandomState(c + f)
    x = np.full((b, h + 2, w + 8, c), np.nan, np.float32)
    x[:, :, :w + 2] = rng.randn(b, h + 2, w + 2, c)
    x = torch.from_numpy(x).to(cuda, torch.bfloat16)
    wf = torch.from_numpy((rng.randn(9 * c, f) / np.sqrt(9 * c))
                          .astype(np.float32)).to(cuda, torch.bfloat16)
    before = k.launches
    with torch.no_grad():
        got = k.make_conv128_kernel(tile_h, h, w, c, f)(x, wf)
        torch.cuda.synchronize()
        want = conv128_plain(x, wf, h, w)
        terms = conv128_plain(x.float().abs(), wf.float().abs(), h, w)
    assert k.launches == before + 1
    assert got.shape == (b, h, w, f) and bool(torch.isfinite(got).all())
    assert _ulp_rule(got, want, terms, 9 * c) <= 1.0


@pytest.mark.parametrize("m,kk,n,tile_m", [
    (4096, 768, 128, 2048), (2048, 576, 64, 2048), (384, 64, 192, 192)])
def test_matmul_kernel_matches_plain_version(cuda, m, kk, n, tile_m):
    from salt_tpu_torch.ops import matmul_kernel as k
    from salt_tpu_torch.ops.probe_conv import matmul_plain
    rng = np.random.RandomState(m + kk)
    a = torch.from_numpy(rng.randn(m, kk).astype(np.float32)).to(
        cuda, torch.bfloat16)
    b = torch.from_numpy((rng.randn(kk, n) / np.sqrt(kk)).astype(np.float32)
                         ).to(cuda, torch.bfloat16)
    before = k.launches
    got = k.make_matmul_kernel(m, kk, n, tile_m)(a, b)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    want = matmul_plain(a, b)
    terms = matmul_plain(a.float().abs(), b.float().abs())
    assert got.shape == (m, n) and _ulp_rule(got, want, terms, kk) <= 1.0


def test_probe_kernels_refuse_bad_inputs(cuda):
    from salt_tpu_torch.ops import conv64p_kernel, conv128_kernel
    from salt_tpu_torch.ops import matmul_kernel
    x, wp = (t.to(cuda) for t in _packed(1, 32, 32, seed=0))
    before = (conv64p_kernel.launches, conv64p_kernel.launches_v2,
              conv128_kernel.launches, matmul_kernel.launches)
    conv = conv64p_kernel.make_conv64p_kernel(16, 32, 32)
    with pytest.raises(TypeError):
        conv(x.float(), wp.float())            # fp32 only on the CPU
    with pytest.raises(ValueError, match="contiguous"):
        conv(x, wp.t().contiguous().t())
    with pytest.raises(TypeError):
        conv64p_kernel.make_conv64p_v2(16, 32, 32, int8=True)(x, wp)
    mm = matmul_kernel.make_matmul_kernel(256, 96, 64, tile_m=128)
    with pytest.raises(ValueError, match="multiples of 64"):
        mm(torch.zeros(256, 96, dtype=torch.bfloat16, device=cuda),
           torch.zeros(96, 64, dtype=torch.bfloat16, device=cuda))
    shape = (1, 34, 40, 128)
    buf = torch.zeros(34 * 40 * 128 + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        conv128_kernel.make_conv128_kernel(16, 32, 32, 128, 64)(
            buf[1:].view(shape),
            torch.zeros(1152, 64, dtype=torch.bfloat16, device=cuda))
    assert (conv64p_kernel.launches, conv64p_kernel.launches_v2,
            conv128_kernel.launches, matmul_kernel.launches) == before
