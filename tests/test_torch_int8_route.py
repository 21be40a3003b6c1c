"""The int8 conv's two card paths, on the CPU: which convs
``ops/int8_conv.py::conv_path`` sends to the TMA + wgmma kernel
(``csrc/int8_conv_wgmma.cu``) and which to the ``mma.sync`` one
(``csrc/int8_conv.cu``), the wgmma kernel's tiles (``wgmma_tile``), its
tile, slab, unit and store arithmetic replayed in PyTorch against the
plain version, and the wrapper's refusals of bad input. The kernels themselves run
only on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from salt_tpu_torch.core.config import default_config
from salt_tpu_torch.models import quant
from salt_tpu_torch.ops import int8_conv as ic
from salt_tpu_torch.train.steps import SegmentationRunner

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

#: the flagship's int8 route in one hflip-TTA step: 57 convs, 49 of them
#: stride-1 3x3 convs with C_in a multiple of 64
FLAGSHIP_SITES, FLAGSHIP_WGMMA = 57, 49


def _flagship_sites():
    """(x shape, w shape, stride, padding, groups) of every int8 conv of
    one hflip-TTA step of the flagship (UNetResNet-34, bf16) at batch 1,
    recorded as ``chip_smoke.py::_int8_sites`` records them on the card;
    each conv returns zeros of its output's shape (only the geometry is
    asked for)."""
    cfg = default_config()
    cfg.model.quant_bits = 8
    cfg.postpro.use_tta = True
    cfg.training.batch_size_inference = 1
    runner = SegmentationRunner(cfg, torch.device("cpu"))
    model = runner.init_model(0)
    sites = []

    def record(x, w, stride=1, padding=0, groups=1):
        sites.append((tuple(x.shape), tuple(w.shape), stride, padding,
                      groups))
        out_h, out_w, _, _ = ic.conv_geometry(x.shape, w.shape, stride,
                                              padding, groups)
        return torch.zeros(x.shape[0], w.shape[0], out_h, out_w,
                           dtype=x.dtype)

    conv, quant.conv2d_int8 = quant.conv2d_int8, record
    try:
        imgs = torch.from_numpy((np.random.RandomState(0).rand(1, 101, 101)
                                 * 255).astype(np.uint8))
        runner.predict_tta_step(model, imgs)
    finally:
        quant.conv2d_int8 = conv
    return sites


def test_flagship_route_sends_49_of_57_convs_to_wgmma():
    sites = _flagship_sites()
    paths = [ic.conv_path(*site) for site in sites]
    assert len(sites) == FLAGSHIP_SITES
    assert paths.count("wgmma") == FLAGSHIP_WGMMA
    # the other 8: the 7x7 stem, three stride-2 3x3, three stride-2 1x1,
    # and the 3x3 over 32 channels at 128x128
    rest = sorted((w[2], ic._pair(s)[0], x[1]) for (x, w, s, _, _), p
                  in zip(sites, paths) if p == "mma")
    assert rest == [(1, 2, 64), (1, 2, 128), (1, 2, 256), (3, 1, 32),
                    (3, 2, 64), (3, 2, 128), (3, 2, 256), (7, 2, 3)]
    for (x, w, _, _, _), p in zip(sites, paths):
        if p == "wgmma":
            assert x[1] % 64 == 0 and w[2:] == (3, 3) and w[0] % 8 == 0


#: (x shape, w shape, stride, padding, groups, path): the card tests'
#: INT8_CONVS and the AQT tests' GEOMETRIES, then the edges of the rule
ROUTES = [((4, 3, 64, 64), (64, 3, 7, 7), 2, 3, 1, "mma"),
          ((3, 64, 32, 32), (64, 64, 3, 3), 1, 1, 1, "wgmma"),
          ((2, 64, 17, 15), (128, 64, 3, 3), 2, 1, 1, "mma"),
          ((2, 64, 16, 16), (128, 64, 1, 1), 2, 0, 1, "mma"),
          ((2, 128, 16, 16), (128, 4, 3, 3), 1, 1, 32, "mma"),
          ((2, 512, 8, 8), (512, 16, 3, 3), 2, 1, 32, "mma"),
          ((3, 48, 9, 11), (40, 48, 3, 3), 1, 1, 1, "mma"),
          ((1, 320, 128, 128), (64, 320, 3, 3), 1, 1, 1, "wgmma"),
          ((2, 3, 32, 32), (64, 3, 7, 7), 2, 3, 1, "mma"),
          ((2, 64, 16, 16), (64, 64, 3, 3), 1, 1, 1, "wgmma"),
          ((2, 64, 16, 16), (128, 64, 3, 3), 2, 1, 1, "mma"),
          ((2, 64, 16, 16), (128, 64, 1, 1), 2, 0, 1, "mma"),
          ((2, 128, 8, 8), (128, 4, 3, 3), 1, 1, 32, "mma"),
          ((2, 64, 8, 8), (60, 64, 3, 3), 1, 1, 1, "mma"),        # O % 8
          ((2, 64, 8, 8), (64, 64, 3, 3), 1, 0, 1, "mma"),        # VALID
          ((2, 64, 8, 8), (64, 64, 3, 3), (1, 2), 1, 1, "mma"),
          ((2, 96, 8, 8), (64, 96, 3, 3), 1, 1, 1, "mma"),        # C 96
          ((2, 64, 8, 8), (64, 64, 3, 3), (1, 1), (1, 1), 1, "wgmma")]


@pytest.mark.parametrize("xs,ws,stride,padding,groups,path", ROUTES)
def test_conv_path(xs, ws, stride, padding, groups, path):
    assert ic.conv_path(xs, ws, stride, padding, groups) == path


@pytest.mark.parametrize("h,w,tile", [(128, 128, (64, 4, 1)),
                                      (64, 64, (64, 4, 1)),
                                      (32, 32, (32, 8, 1)),
                                      (16, 16, (16, 16, 1)),
                                      (8, 8, (8, 8, 4)),
                                      (9, 11, (16, 16, 1)),
                                      (17, 70, (64, 4, 1)),
                                      (4, 16, (16, 4, 4)),
                                      (1, 1, (8, 8, 4))])
def test_wgmma_tile(h, w, tile):
    assert ic.wgmma_tile(h, w) == tile


def test_wgmma_tiles_fit_the_kernel():
    """Every map from 1x1 to 130x130: 256 pixels a tile, whole rows of one
    image a 64-pixel unit, power-of-two sides, tile_w 8..64 covering the
    row where it can, and a slab within the kernel's 432 pixels."""
    for h in range(1, 131):
        for w in range(1, 131):
            tw, th, tb = ic.wgmma_tile(h, w)
            assert tw * th * tb == ic.WGMMA_TILE_PIXELS, (h, w)
            assert (tw * th) % 64 == 0 and tw in (8, 16, 32, 64), (h, w)
            assert th & (th - 1) == 0 and (tw >= w or tw == 64), (h, w)
            assert tb * (th + 2) * (tw + 2) <= ic.WGMMA_SLAB_PIXELS, (h, w)


def _replay_wgmma(xq, sx, wq, sw, out_dtype, nt):
    """``csrc/int8_conv_wgmma.cu``'s arithmetic of indices in PyTorch: the
    persistent loop's tiles (``tile_of``), each (tile, chunk) step's slab
    as its TMA box loads it (a row and a column before the tile, zeros
    outside the input), the weight boxes (rows past O zero), each lane's
    slab pixel (``a_base`` plus the tap's shift), and the epilogue's
    units stored as boxes of 64 / tile_w rows that TMA clips at W, H, B
    and O; ``nt`` output channels a tile (the kernel takes 128 where O is
    a multiple of 128 and the tiles fill half the SMs, else 64). Returns
    the output and how often each element was stored."""
    b, c, h, w = xq.shape
    o = wq.shape[0]
    tw, th, tb = ic.wgmma_tile(h, w)
    kc = 128 if c % 128 == 0 else 64
    x = xq.permute(0, 2, 3, 1).long()                # NHWC
    wk = wq.permute(0, 2, 3, 1).reshape(o, 9 * c).long()  # [O][9C]
    tiles_w, tiles_h, n_fb = -(-w // tw), -(-h // th), -(-o // nt)
    n_tiles = -(-b // tb) * tiles_h * tiles_w * n_fb
    out = torch.zeros(b, h, w, o, dtype=out_dtype)
    stores = torch.zeros(b, h, w, o, dtype=torch.long)
    m = torch.arange(ic.WGMMA_TILE_PIXELS)
    a_base = (((m // (tw * th)) * (th + 2) + (m // tw) % th) * (tw + 2)
              + m % tw)
    for tile in range(n_tiles):
        fb, t = tile % n_fb, tile // n_fb
        x0, y0 = (t % tiles_w) * tw, ((t // tiles_w) % tiles_h) * th
        b0 = t // (tiles_w * tiles_h) * tb
        acc = torch.zeros(ic.WGMMA_TILE_PIXELS, nt, dtype=torch.long)
        wbox = torch.zeros(nt, 9 * c, dtype=torch.long)
        wbox[:max(0, min(nt, o - fb * nt))] = wk[fb * nt:fb * nt + nt]
        for chunk in range(c // kc):
            slab = torch.zeros(tb, th + 2, tw + 2, kc, dtype=torch.long)
            for n in range(tb):
                for r in range(th + 2):
                    for col in range(tw + 2):
                        bi, yi, xi = b0 + n, y0 - 1 + r, x0 - 1 + col
                        if bi < b and 0 <= yi < h and 0 <= xi < w:
                            slab[n, r, col] = x[bi, yi, xi,
                                                chunk * kc:(chunk + 1) * kc]
            flat = slab.reshape(-1, kc)
            for tap in range(9):
                p = a_base + (tap // 3) * (tw + 2) + tap % 3
                k0 = tap * c + chunk * kc
                acc += flat[p] @ wbox[:, k0:k0 + kc].T
        for unit in range(ic.WGMMA_TILE_PIXELS // 64):
            m0 = unit * 64
            bi = b0 + m0 // (tw * th)
            y = y0 + (m0 // tw) % th
            if not (bi < b and y < h):
                continue
            xs = sx[min(bi, b - 1)]
            for i in range(64):
                yi, xi = y + i // tw, x0 + i % tw
                if yi >= h or xi >= w:
                    continue
                ch = torch.arange(fb * nt, min(o, fb * nt + nt))
                v = (acc[m0 + i, :len(ch)].float() * xs) * sw[ch]
                out[bi, yi, xi, ch] = v.to(out_dtype)
                stores[bi, yi, xi, ch] += 1
    return out.permute(0, 3, 1, 2), stores


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,c,h,w,o,nt", [(2, 64, 9, 11, 32, 64),
                                          (5, 128, 8, 8, 64, 64),
                                          (1, 64, 6, 70, 136, 64),
                                          (3, 192, 16, 16, 40, 64),
                                          (2, 256, 8, 8, 256, 128),
                                          (2, 256, 8, 8, 256, 64)])
def test_wgmma_index_arithmetic_replays_the_conv(b, c, h, w, o, nt, dtype):
    """The replay of the kernel's indices equals the plain version bit
    for bit and stores every output element once: 64-byte chunks (C 64,
    192), 128-byte ones, four 8x8 images a tile (the last tile part
    empty), ragged rows and columns, three NT blocks with the last partly
    past O, O under NT, O 256 in NT blocks of 128 and of 64."""
    rng = np.random.RandomState(b * c + o)
    x = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(dtype)
    wt = torch.from_numpy((rng.randn(o, c, 3, 3) / np.sqrt(9 * c)).astype(
        np.float32)).to(dtype)
    xq, sx = ic.quantize_activation(x)
    wq, sw = ic.quantize_weight(wt)
    got, stores = _replay_wgmma(xq, sx, wq, sw, dtype, nt)
    want = ic.int8_conv2d_plain(xq, sx, wq, sw, 1, 1, 1, dtype)
    assert torch.equal(got, want)
    assert bool((stores == 1).all())


def test_wrapper_refuses_bad_inputs_on_the_cpu():
    """On the CPU too, before anything runs: a path other than None or
    "mma", a 3-D input, float operands, scales of the wrong length, and
    channels that the groups do not divide; no counter moves."""
    xq = torch.zeros(1, 64, 8, 8, dtype=torch.int8)
    wq = torch.zeros(64, 64, 3, 3, dtype=torch.int8)
    s1, s64 = torch.ones(1), torch.ones(64)
    before = (ic.conv_launches, ic.wgmma_launches, ic.mma_launches)
    with pytest.raises(ValueError, match="path"):
        ic.int8_conv2d(xq, s1, wq, s64, 1, 1, path="wgmma")
    with pytest.raises(ValueError, match="path"):
        ic.int8_conv2d(xq, s1, wq, s64, 1, 1, path="cudnn")
    with pytest.raises(ValueError):
        ic.int8_conv2d(xq[0], s1, wq, s64, 1, 1)
    with pytest.raises(TypeError):
        ic.int8_conv2d(xq.float(), s1, wq, s64, 1, 1)
    with pytest.raises(ValueError, match="scales"):
        ic.int8_conv2d(xq, s64, wq, s64, 1, 1)
    with pytest.raises(ValueError):
        ic.int8_conv2d(xq, s1, wq[:, :5], s64, 1, 1, groups=3)
    assert (ic.conv_launches, ic.wgmma_launches, ic.mma_launches) == before


@pytest.mark.parametrize("path", [None, "mma"])
def test_cpu_tensors_take_the_plain_version_on_either_path(path):
    """A CPU tensor goes to the plain version whatever the path, and no
    kernel counter moves."""
    rng = np.random.RandomState(7)
    xq = torch.from_numpy(rng.randint(-127, 128, (2, 64, 8, 8)).astype(
        np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (32, 64, 3, 3)).astype(
        np.int8))
    sx = torch.tensor([0.01, 0.02])
    sw = torch.linspace(0.001, 0.002, 32)
    before = (ic.conv_launches, ic.wgmma_launches, ic.mma_launches)
    got = ic.int8_conv2d(xq, sx, wq, sw, 1, 1, 1, torch.bfloat16, path=path)
    assert torch.equal(got, ic.int8_conv2d_plain(xq, sx, wq, sw, 1, 1, 1,
                                                 torch.bfloat16))
    assert (ic.conv_launches, ic.wgmma_launches, ic.mma_launches) == before
