"""Tests that need the card: the preprocess, bitonic sort and 3x3 conv
CUDA kernels and the conv and matmul probe kernels against their plain
versions (the preprocess kernel also at B 0, on extreme edge bytes, on an
unaligned input and on a side stream), their launch counts and input
checks, a small serve step on the
card against the CPU, a predict step through the conv kernel, and one
bf16 train step.
Marked ``cuda``; they skip where CUDA is absent and run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

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


def _check_preprocess(imgs, got, got16):
    """fp32 within atol=1e-5 of the plain version; bf16 within one bf16
    ulp of the plain fp32 result cast to bf16."""
    from salt_tpu_torch.ops.preprocess import preprocess_inference
    want = preprocess_inference(imgs)
    assert got.shape == (imgs.shape[0], 128, 128, 3)
    assert got.dtype == torch.float32 and got16.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    want16 = want.to(torch.bfloat16).float()
    ulp = torch.abs(want16) * 2.0 ** -7 + 1e-30
    assert bool((torch.abs(got16.float() - want16) <= ulp).all())


@pytest.mark.parametrize("b", [1, 5, 48, 97, 384])
def test_kernel_matches_plain_version(cuda, b):
    """fp32 within atol=1e-5 of the plain version; bf16 within one bf16
    ulp of the plain fp32 result cast to bf16."""
    from salt_tpu_torch.ops import preprocess_kernel as pk
    imgs = _images(b, seed=b).to(cuda)
    before = pk.launches
    got = pk.preprocess_inference_kernel(imgs, torch.float32)
    got16 = pk.preprocess_inference_kernel(imgs, torch.bfloat16)
    torch.cuda.synchronize()
    assert pk.launches == before + 2
    _check_preprocess(imgs, got, got16)


def test_kernel_empty_batch(cuda):
    """B 0: the plain version's empty result, in both dtypes, and no
    launch."""
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.ops.preprocess import preprocess_inference
    imgs = _images(0).to(cuda)
    before = pk.launches
    for dtype in (torch.float32, torch.bfloat16):
        got = pk.preprocess_inference_kernel(imgs, dtype)
        want = preprocess_inference(imgs, "edge", dtype)
        assert got.shape == want.shape == (0, 128, 128, 3)
        assert got.dtype == want.dtype == dtype
    assert pk.launches == before


def test_kernel_edge_pad_copies_extreme_bytes(cuda):
    """Bytes 0 / 1 / 127 / 128 / 254 / 255 in the four corners and along
    the four edges, which the edge pad copies out to the border."""
    from salt_tpu_torch.ops import preprocess_kernel as pk
    imgs = _images(4, seed=11)
    values = torch.tensor([0, 1, 127, 128, 254, 255], dtype=torch.uint8)
    edge = values.repeat(17)[:101]
    for i in range(4):
        e = edge.roll(i)
        imgs[i, 0], imgs[i, -1], imgs[i, :, 0], imgs[i, :, -1] = e, e, e, e
        imgs[i, 0, 0], imgs[i, 0, -1] = values[i], values[i + 1]
        imgs[i, -1, 0], imgs[i, -1, -1] = values[i + 2], values[5 - i]
    imgs = imgs.to(cuda)
    got = pk.preprocess_inference_kernel(imgs, torch.float32)
    got16 = pk.preprocess_inference_kernel(imgs, torch.bfloat16)
    torch.cuda.synchronize()
    _check_preprocess(imgs, got, got16)


@pytest.mark.parametrize("offset", ["slice", "one_byte"])
def test_kernel_reads_an_input_at_an_odd_byte(cuda, offset):
    """``buf[1:]`` of a contiguous [B + 1, 101, 101] batch (10,201 bytes
    in, as ``predict_dataset`` slices a batch) and a batch one byte into
    a flat buffer: both contiguous, neither aligned."""
    from salt_tpu_torch.ops import preprocess_kernel as pk
    b = 7
    if offset == "slice":
        imgs = _images(b + 1, seed=12).to(cuda)[1:]
    else:
        buf = torch.empty(b * 101 * 101 + 1, dtype=torch.uint8, device=cuda)
        imgs = buf[1:].view(b, 101, 101)
        imgs.copy_(_images(b, seed=13))
    assert imgs.is_contiguous() and imgs.data_ptr() % 2 == 1
    got = pk.preprocess_inference_kernel(imgs, torch.float32)
    got16 = pk.preprocess_inference_kernel(imgs, torch.bfloat16)
    torch.cuda.synchronize()
    _check_preprocess(imgs, got, got16)


def test_kernel_launches_on_the_current_stream(cuda):
    """On a side stream whose input is written there after a long sleep:
    a launch on any other stream would read the zeros that were there."""
    from salt_tpu_torch.ops import preprocess_kernel as pk
    src = _images(48, seed=14).to(cuda)
    imgs = torch.zeros_like(src)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        imgs.copy_(src)
        got = pk.preprocess_inference_kernel(imgs, torch.float32)
        got16 = pk.preprocess_inference_kernel(imgs, torch.bfloat16)
    side.synchronize()
    _check_preprocess(src, got, got16)


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


def _sort_inputs(b, p, keys_kind, seed=0):
    """Keys "distinct", "ties" (rounded to quarters) or "nan_zeros" (ties,
    with NaNs, +0.0 and -0.0 mixed in); a Lovász-style payload."""
    rng = np.random.RandomState(seed)
    keys = rng.randn(b, p).astype(np.float32)
    if keys_kind != "distinct":
        keys = np.round(keys * 4) / 4
    if keys_kind == "nan_zeros":
        keys[rng.rand(b, p) < 0.05] = np.nan
        keys[rng.rand(b, p) < 0.1] = 0.0
        keys[rng.rand(b, p) < 0.1] = -0.0
    payload = ((rng.randint(0, 2, (b, p)) << 20)
               | np.arange(p)).astype(np.int32)
    return torch.from_numpy(keys), torch.from_numpy(payload)


@pytest.mark.parametrize("ties", ["distinct", "ties", "nan_zeros"])
@pytest.mark.parametrize("shape", [(1, 32768), (5, 32768), (24, 32768),
                                   (3, 1024), (8, 32768), (1, 128), (2, 4096),
                                   (2, 8192), (16, 32768), (17, 32768)])
def test_sort_kernel_is_bit_identical_to_the_network(cuda, shape, ties):
    """Keys and payload bit for bit, at the paths' shape (24 rows of
    32,768: the train batch, and validation pads to it), at 8 rows, at
    the plan's chunk edges and on both sides of the wrapper's choice of
    chunk (16 and 17 rows of 32,768 on 132 SMs); one ``launches`` per
    call, the plan's length of ``device_launches``."""
    from salt_tpu_torch.ops import sort_kernel as sk
    from salt_tpu_torch.ops.bitonic import bitonic_sort_desc
    keys, payload = _sort_inputs(*shape, ties, seed=shape[0])
    keys, payload = keys.to(cuda), payload.to(cuda)
    before, device_before = sk.launches, sk.device_launches
    got_k, got_p = sk.sort_desc(keys, payload)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    assert sk.device_launches == (device_before
                                  + len(sk.card_plan(*shape, keys.device)))
    want_k, want_p = bitonic_sort_desc(keys, payload)
    assert torch.equal(got_k.view(torch.int32), want_k.view(torch.int32))
    assert torch.equal(got_p, want_p)


def test_sort_kernel_lovasz_value_and_gradient_match_cpu(cuda):
    """The per-image Lovász hinge through the kernel at (8, 32768) with
    ties against the CPU, where the plain network sorts: the same
    permutation, so only the order of the sums differs (rtol 1e-5,
    atol 1e-7, as chip_smoke.py holds it at 24 rows)."""
    from salt_tpu_torch.ops import sort_kernel as sk
    rng = np.random.RandomState(5)
    logits = torch.from_numpy(
        (np.round(rng.randn(8, 32768) * 8) / 8).astype(np.float32))
    labels = torch.from_numpy((rng.rand(8, 32768) > 0.6).astype(np.float32))
    results = []
    for d in (cuda, torch.device("cpu")):
        x = logits.to(d).requires_grad_(True)
        before = sk.launches
        loss = sk.lovasz_hinge_flat_kernel(x, labels.to(d)).mean()
        loss.backward()
        assert sk.launches == before + (1 if d.type == "cuda" else 0)
        results.append((loss.detach().cpu(), x.grad.cpu()))
    torch.testing.assert_close(results[0][0], results[1][0], rtol=1e-5,
                               atol=1e-7)
    torch.testing.assert_close(results[0][1], results[1][1], rtol=1e-5,
                               atol=1e-7)


def test_sort_kernel_refuses_bad_inputs(cuda):
    from salt_tpu_torch.ops.sort_kernel import sort_desc
    keys, payload = _sort_inputs(2, 1024, "distinct")
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
    shifted_k = torch.zeros(2 * 1024 + 1, device=cuda)[1:].view(2, 1024)
    with pytest.raises(ValueError, match="aligned"):
        sort_desc(shifted_k, payload)


def _conv_inputs(b, c, hx, wx, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, hx, wx, c).astype(np.float32))
    w = torch.from_numpy((rng.randn(64, c, 3, 3) / np.sqrt(9 * c))
                         .astype(np.float32))
    return x.permute(0, 3, 1, 2).to(torch.bfloat16), w.to(torch.bfloat16)


@pytest.mark.parametrize("b,c,hx,wx,halo", [
    (2, 64, 64, 64, False), (2, 64, 66, 66, True), (1, 64, 32, 32, False),
    (1, 32, 40, 48, False), (1, 320, 64, 64, False), (3, 64, 130, 130, True),
    (1, 16, 33, 70, False),
    # H not a multiple of the kernel's 4-row tile, W = 34, and a tile
    # count (9 * 16 = 144) that does not divide a 132-SM grid
    (1, 64, 38, 34, False), (2, 32, 36, 36, True), (9, 64, 64, 64, False)])
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
    (K = 768) of the plain version, and equal to each other (one kernel);
    (3, 8, 20, 4) has 40-pair grid tiles, so the kernel's 4 x 64-pair
    tiles are ragged there."""
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
    assert torch.equal(got5, got7)


@pytest.mark.parametrize("b,h,w,tile_h", [
    (1, 6, 2, 3), (3, 6, 20, 3), (1, 8, 20, 4), (3, 12, 130, 6),
    (1, 4, 256, 4)])
def test_conv64p_row5_ragged_and_unread_columns(cuda, b, h, w, tile_h):
    """Row 5 (``csrc/conv_valid.cu``, KW 2) at heights and widths that its
    4 x 64-pair tiles do not divide, batch 1 and 3; the packed columns
    past W/2 hold NaN, which a load of them would carry into the output.
    One bf16 ulp plus 2 K 2^-24 sum|x||w| (K = 768) of the plain version;
    one launch a call."""
    from salt_tpu_torch.ops import conv64p_kernel as k
    from salt_tpu_torch.ops.probe_conv import conv64p_plain
    x, wp = (t.to(cuda) for t in _packed(b, h, w, seed=b + h + w))
    x[:, :, w // 2 + 1:] = float("nan")
    before = (k.launches, k.launches_v2)
    with torch.no_grad():
        got = k.make_conv64p_kernel(tile_h, h, w)(x, wp)
        torch.cuda.synchronize()
        want = conv64p_plain(x, wp, h, w)
        terms = conv64p_plain(x.float().abs(), wp.float().abs(), h, w)
    assert (k.launches, k.launches_v2) == (before[0] + 1, before[1])
    assert got.shape == (b, h, w // 2, 128) and bool(torch.isfinite(got).all())
    assert _ulp_rule(got, want, terms, 768) <= 1.0


@pytest.mark.parametrize("b,h,w", [
    (1, 6, 2), (3, 6, 20), (3, 12, 130), (1, 4, 256)])
def test_conv64p_int8_ragged_and_unread_columns(cuda, b, h, w):
    """Row 7 in int8 (``csrc/conv_valid.cu``, s8 wgmma, K-major weights)
    bit for bit against ``valid_conv_plain`` at heights and widths that its
    4 x 64-pair tiles do not divide, batch 1 and 3; full-range operands
    (-128 in the weights, -127 .. 127 in x) and 127 in the packed columns
    past W/2, which a load of them would carry into the output. One launch
    a call."""
    from salt_tpu_torch.ops import conv64p_kernel as k
    from salt_tpu_torch.ops.probe_conv import valid_conv_plain
    x, wp = (t.to(cuda) for t in _packed(b, h, w, seed=b + h + w,
                                         dtype=torch.int8))
    wp[0, :64] = -128
    x[:, :, w // 2 + 1:] = 127
    before = (k.launches, k.launches_v2)
    with torch.no_grad():
        got = k.make_conv64p_v2(h, h, w, db=True, int8=True)(x, wp)
        torch.cuda.synchronize()
    assert (k.launches, k.launches_v2) == (before[0], before[1] + 1)
    want = valid_conv_plain(x, wp, 3, 2, h, w // 2)
    assert got.shape == (b, h, w // 2, 128) and got.dtype == torch.bfloat16
    assert bool((wp == -128).any()) and torch.equal(got, want)


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
    (1, 8, 40, 128, 192, 8), (3, 6, 24, 128, 128, 3),
    (1, 6, 40, 256, 192, 3), (3, 6, 40, 128, 64, 2),
    (1, 4, 130, 128, 128, 4)])
def test_conv128_kernel_matches_plain_version(cuda, b, h, w, c, f, tile_h):
    """Row 4 (``csrc/conv_valid.cu``, KW 3) in bf16, K = 9C; the input
    columns past W+1 hold NaN. Heights and widths that the kernel's 4 x 64
    tiles do not divide, F 64 / 128 / 192 (column tiles of 64 or 128), C
    256 (four channel chunks), batch 1 and 3."""
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


@pytest.mark.parametrize("m,kk,n", [
    (100, 64, 64), (1000, 576, 64), (777, 768, 128), (4099, 1152, 192),
    (300, 64, 192), (2500, 1152, 64), (513, 576, 128), (6000, 768, 128)])
def test_matmul_kernel_ragged_rows(cuda, m, kk, n):
    """Row 6 (``csrc/matmul_wgmma.cu``) at M that its 128-row tiles do not
    divide (tile_m = M), K 64 / 576 / 768 / 1152 and N 64 / 128 / 192
    (column tiles of 64 or 128), within one bf16 ulp plus 2 K 2^-24
    sum|a||b|; one launch a call, and b is not changed."""
    from salt_tpu_torch.ops import matmul_kernel as k
    from salt_tpu_torch.ops.probe_conv import matmul_plain
    rng = np.random.RandomState(m + kk + n)
    a = torch.from_numpy(rng.randn(m, kk).astype(np.float32)).to(
        cuda, torch.bfloat16)
    b = torch.from_numpy((rng.randn(kk, n) / np.sqrt(kk)).astype(np.float32)
                         ).to(cuda, torch.bfloat16)
    b_before = b.clone()
    before = k.launches
    got = k.make_matmul_kernel(m, kk, n, tile_m=m)(a, b)
    torch.cuda.synchronize()
    assert k.launches == before + 1 and torch.equal(b, b_before)
    want = matmul_plain(a, b)
    terms = matmul_plain(a.float().abs(), b.float().abs())
    assert got.shape == (m, n) and bool(torch.isfinite(got.float()).all())
    assert _ulp_rule(got, want, terms, kk) <= 1.0


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


def _salt_unet_config(arch="SaltUNet"):
    from salt_tpu_torch.core.config import default_config
    cfg = default_config()
    cfg.model.architecture = arch
    cfg.model.n_filters = 4
    cfg.model.repeat_blocks = 2
    cfg.training.dtype = "float32"
    cfg.training.batch_size_inference = 4
    cfg.training.batch_size_train = 4
    return cfg


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("arch", ["SaltUNet", "SaltLinkNet"])
def test_scratch_nets_on_card_match_cpu(cuda, arch, train):
    """The scratch nets' fp32 logits on the card (TF32 off) against the
    CPU from one seeded model, eval and train mode: rtol=atol=2e-3."""
    import copy
    from salt_tpu_torch.models.registry import build_model, init_seeded
    model = init_seeded(build_model(_salt_unet_config(arch).model), seed=2)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 64, 64)
                         .astype(np.float32))
    card = copy.deepcopy(model).to(cuda, memory_format=torch.channels_last)
    model.train(train)
    card.train(train)
    with torch.no_grad():
        want, got = model(x), card(x.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-3)


def _rle_masks(sub):
    """[N, 101, 101] masks of a submission frame (column-major,
    1-indexed (start, length) runs)."""
    masks = np.zeros((len(sub), 101 * 101), np.uint8)
    for i, rle in enumerate(sub["rle_mask"]):
        runs = [int(v) for v in str(rle).split()]
        for start, length in zip(runs[0::2], runs[1::2]):
            masks[i, start - 1:start - 1 + length] = 1
    return masks.reshape(-1, 101, 101).transpose(0, 2, 1)


def test_serve_synthetic_on_card_matches_cpu(cuda, tmp_path):
    """``serve --synthetic 10`` of one seeded SaltUNet checkpoint on the
    card and on the CPU (fp32, hflip TTA, batch 4): the same ids, masks
    under the threshold-margin rule against the float16 archives (slack
    1e-3); the preprocess kernel once per timed and warm-up batch. Then
    with no checkpoint: the seeded weights."""
    import json
    import pandas as pd
    from salt_tpu_torch.core.experiment import checkpoint_path, save_flat_npz
    from salt_tpu_torch.models.convert import to_flax_flat
    from salt_tpu_torch.models.registry import build_model, init_seeded
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.pipeline.serving import serve
    cfg = _salt_unet_config()
    cfg.postpro.use_tta = True
    exp = str(tmp_path / "exp")
    save_flat_npz(checkpoint_path(exp),
                  to_flax_flat(init_seeded(build_model(cfg.model), 6)))
    with open(tmp_path / "exp" / "config.json", "w") as f:
        json.dump(cfg.to_dict(), f)
    out = {}
    for dev in ("cpu", cuda):
        name = str(dev)
        before = pk.launches
        r = serve(cfg, exp, "", str(tmp_path / f"{name}.csv"),
                  str(tmp_path / f"{name}.npz"), synthetic=10, device=dev)
        out[name] = (pd.read_csv(tmp_path / f"{name}.csv",
                                 keep_default_na=False),
                     np.load(r["probs_out"], allow_pickle=True)["probs"]
                     .astype(np.float32), pk.launches - before, r)
    (sub_c, p_c, _, _), (sub_g, p_g, launched, r) = out["cpu"], out["cuda"]
    assert launched == r["batches"] + r["warmup_batches"] == 6
    assert sub_c["id"].tolist() == sub_g["id"].tolist()
    delta = float(np.abs(p_g - p_c).max())
    assert delta < 1e-3
    decidable = np.abs(p_c - 0.5) > delta + 1e-3
    m_c, m_g = _rle_masks(sub_c), _rle_masks(sub_g)
    np.testing.assert_array_equal(m_g[decidable], m_c[decidable])
    r = serve(cfg, "", "", str(tmp_path / "seeded.csv"), synthetic=10,
              device=cuda)
    assert r["n"] == 10


@pytest.mark.parametrize("name", ["dice", "mixed_dice_bce", "mixed_dice_ce",
                                  "focal", "focal_weighted"])
def test_losses_on_card_match_cpu(cuda, name):
    """Value and gradient on the card against the CPU, fp32, batch 4 of
    NHWC 128 x 128 x 2: rtol 1e-4, gradients within 1e-6 of their
    largest magnitude (the devices sum in different orders)."""
    from salt_tpu_torch.losses.api import get_loss_fn
    rng = np.random.RandomState(5)
    logits = torch.from_numpy((3 * rng.randn(4, 128, 128, 2))
                              .astype(np.float32))
    masks = (rng.rand(4, 16, 16) > 0.5).repeat(8, 1).repeat(8, 2)
    masks[0] = 0
    target = torch.from_numpy(np.stack([1 - masks, masks], -1)
                              .astype(np.float32))
    fn = get_loss_fn(name)
    out = []
    for dev in ("cpu", cuda):
        x = logits.to(dev, copy=True).requires_grad_(True)
        value = fn(x, target.to(dev))
        value.backward()
        out.append((value.detach().cpu(), x.grad.cpu()))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-4, atol=0)
    torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-4,
                               atol=1e-6 * float(out[0][1].abs().max()))


def test_optax_last_resumes_on_card(cuda):
    """A ``last`` checkpoint in the JAX package's optax layout (the L2
    term's chain index) resumes on the card: the moments on each
    parameter's device in its memory format, Adam's step and the learning
    rate, and one step runs."""
    from salt_tpu_torch.models.convert import to_flax_flat
    from salt_tpu_torch.train.steps import SegmentationRunner
    cfg = _salt_unet_config()
    cfg.training.l2_reg_conv = 1e-4
    runner = SegmentationRunner(cfg, device=cuda)
    state = runner.init_state(0)
    flat = to_flax_flat(state.model)
    rng = np.random.RandomState(0)
    arrays = dict(flat)
    arrays["opt_state/hyperparams/learning_rate"] = np.float32(2e-3)
    arrays["opt_state/count"] = np.int32(3)
    arrays["opt_state/inner_state/1/0/count"] = np.int32(3)
    arrays["step"] = np.int32(3)
    for k, v in flat.items():
        if k.startswith("params/"):
            tail = k[len("params/"):]
            arrays[f"opt_state/inner_state/1/0/mu/{tail}"] = (
                rng.randn(*v.shape).astype(np.float32))
            arrays[f"opt_state/inner_state/1/0/nu/{tail}"] = (
                rng.rand(*v.shape).astype(np.float32))
    state.load_optimizer_arrays(arrays)
    assert state.step == 3 and state.learning_rate == pytest.approx(2e-3)
    for p in state.model.parameters():
        st = state.optimizer.state[p]
        assert st["exp_avg"].device == p.device and int(st["step"]) == 3
        assert st["exp_avg"].stride() == p.stride()
    imgs = _images(4, seed=1).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    assert torch.isfinite(runner.train_step(state, imgs,
                                            (imgs > 128).to(torch.uint8), g))


def test_validation_image_monitor_on_card(cuda, tmp_path):
    """The monitor's PNG from one seeded SaltUNet on the card against the
    CPU's: the input and target columns equal, the prediction column
    within one grey level."""
    from types import SimpleNamespace
    from PIL import Image
    from salt_tpu_torch.data.bundle import synthetic_bundle
    from salt_tpu_torch.models.registry import build_model, init_seeded
    from salt_tpu_torch.train.callbacks import ValidationImageMonitor
    from salt_tpu_torch.train.steps import SegmentationRunner
    cfg = _salt_unet_config()
    bundle = synthetic_bundle(4, seed=2)
    grids = []
    for dev in ("cpu", cuda):
        runner = SegmentationRunner(cfg, device=dev)
        model = runner.place(init_seeded(build_model(cfg.model), 3))
        d = tmp_path / str(dev)
        ValidationImageMonitor(str(d), runner, bundle.images, bundle.masks,
                               image_nr=4, image_every=1).on_epoch_end(
            {"epoch_id": 0, "state": SimpleNamespace(model=model)})
        grids.append(np.asarray(Image.open(
            d / "validation_epoch_0000.png")).astype(np.int16))
    assert grids[0].shape == grids[1].shape == (4 * 101, 3 * 101)
    for col in (0, 2):
        np.testing.assert_array_equal(grids[1][:, col * 101:(col + 1) * 101],
                                      grids[0][:, col * 101:(col + 1) * 101])
    assert np.abs(grids[1] - grids[0]).max() <= 1


def test_bench_tiny_on_card(cuda):
    """The bench tool at its tiny size on the card: every key, positive
    rates, and the breakdown measured with the preprocess kernel once per
    TTA step and the sort kernel in the train step."""
    from salt_tpu_torch.tools import bench
    line = bench.main(["--tiny", "--iters", "2", "--windows", "1",
                       "--train-iters", "2", "--profile-steps", "2"])
    assert line["device"]["platform"] == "gpu"
    assert line["flagship_tta_int8"] is None
    tta = line["breakdown"]["tta_step"]
    train = line["breakdown"]["train_step"]
    assert tta["device_ms"] > 0 and 0 < tta["busy_share"]
    assert tta["kernels"]["preprocess_inference_kernel"][
        "launches_per_step"] == 1
    assert train["kernels"][bench.KERNEL_PREFIX]["launches_per_step"] > 0


def test_whole_session_kernel_ms_on_card(cuda):
    """``tools/profiling.kernel_ms`` of the preprocess kernel (bf16
    out): one launch a call, a time above the kernel's bytes bound."""
    from salt_tpu_torch.ops import preprocess_kernel as pk
    from salt_tpu_torch.tools.profiling import kernel_ms
    imgs = _images(48, seed=4).to(cuda)
    ms = kernel_ms(lambda: pk.preprocess_inference_kernel(imgs),
                   "preprocess_inference_kernel", iters=20,
                   launches_per_call=1)
    bound = (48 * 101 * 101 + 48 * 128 * 128 * 3 * 2) / 3.35e12 * 1e3
    assert ms > bound
