"""Int8 convolution of the infer form under ``model.quant_bits=8``: the
quantizer and the s8 x s8 -> s32 convolution, their CUDA kernels
(``csrc/int8_quant.cu``; ``csrc/int8_conv_wgmma.cu`` and
``csrc/int8_conv.cu``) and their plain versions.

The JAX package's int8 route is AQT's ``conv_general_dilated``
(``salt_tpu/models/quant.py:24-34``), an XLA convolution and no Pallas
kernel. Its numerics, as the installed AQT computes them
(``aqt/jax/v2/aqt_conv_general.py``, ``calibration.py``
``AbsMaxCalibration``, ``aqt_tensor.py`` ``QTensor.quant`` / ``dequant``,
``numerics/int_numerics.py`` ``IntSymmetric`` with ``preserve_zero``),
all in the compute dtype D of the conv's operands (fp32 or bf16):

- one scale per *row*: the activation's per image, shared over H, W and
  C_in (``lhs`` calibration axes 1..3), the weight's per output channel,
  shared over KH, KW and C_in / groups (``rhs`` axes 0..2);
- ``absmax`` of the row, 0 replaced by 1; ``scale = absmax / 127.5`` (the
  edge of the last of 255 buckets), rounded to D. XLA compiles that
  division by a constant into a product with its float32 reciprocal
  (0.00784313772, :data:`INV_EDGE`) in fp32, and the JAX package's
  forwards run compiled, so the scale here is ``absmax * INV_EDGE`` in
  fp32, rounded to D (eager JAX divides; the two differ by an ulp of
  the scale in about 7 rows of 10);
- ``inv = 1 / scale`` rounded to D (1 where it is infinite), then
  ``x * inv`` rounded to D: AQT multiplies by the reciprocal, it does not
  divide;
- clipped to +-127.0, rounded half to even, cast to int8;
- the conv of the integer values, then the output times the activation
  scale of its image, times the weight scale of its channel.

AQT convolves the integers in D (in bf16 its sums round to bf16 before
the scales apply). Here the s32 sum is exact and the dequantization is
``(float(acc) * s_x[b]) * s_w[o]`` in fp32, rounded to D once: in fp32
the same as AQT while its sums stay under 2^24, in bf16 within a few
bf16 ulps of it (tests/test_torch_int8_conv.py).

- :func:`quantize_rows` -> (int8 values, fp32 scales) of a [R, L] tensor:
  ``csrc/int8_quant.cu`` for a CUDA tensor (one call, two launches: the
  partial abs-maxima of each row's chunks, then the scale and the
  values), :func:`quantize_rows_plain` for a CPU one.
- :func:`int8_conv2d` -> the dequantized conv: for a CUDA tensor one of
  two kernels, as :func:`conv_path` routes the geometry:
  ``csrc/int8_conv_wgmma.cu`` (TMA + wgmma s8, "wgmma") for the 3x3,
  stride 1, padding 1, groups 1 convs with C_in a multiple of 64, and
  ``csrc/int8_conv.cu`` (``mma.sync`` s8, "mma") for every other; for a
  CPU one :func:`int8_conv2d_plain` (``F.conv2d`` in float64 over the
  integers, exact, then the same dequantization).
- :func:`conv2d_int8` quantizes both operands of one conv and runs it;
  ``models.quant.make_conv_fn`` wraps it as an ``F.conv2d``-compatible
  callable.

A CUDA tensor launches the kernels or raises: nothing falls back.
``quantize_launches`` counts the calls that launched the quantizer,
``wgmma_launches`` and ``mma_launches`` those that launched each conv
kernel, ``conv_launches`` both, and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from salt_tpu_torch.ops import build, costs

#: the clip bound and the bucket edge of AQT's 8-bit ``preserve_zero``
QMAX = 127.0
BUCKET_EDGE = 127.5
#: float32(1 / 127.5), the factor XLA puts in place of the division
INV_EDGE = 0.007843137718737125
#: elements of a row that one block of the quantizer's passes reads
CHUNK = 8192
#: the largest K (KH KW C_in / groups, padded to 32) the conv kernel's
#: gather table holds where C_in / groups is not a multiple of 16
GATHER_K = 1024
DTYPES = (torch.float32, torch.bfloat16)

#: calls that launched the quantize kernel (two launches each)
quantize_launches = 0
#: calls that launched an int8 conv kernel (one launch each): either
#: path, and each path's own
conv_launches = 0
wgmma_launches = 0
mma_launches = 0
#: output pixels of a tile of the wgmma kernel, and the most pixels its
#: input slab holds (tile_b x (tile_h + 2) x (tile_w + 2))
WGMMA_TILE_PIXELS = 256
WGMMA_SLAB_PIXELS = 432

_Pair = Union[int, Sequence[int]]


def _pair(v: _Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


# -- the quantizer -------------------------------------------------------------
def quantize_rows_plain(rows: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R, L] in D -> (int8 [R, L], fp32 [R] scales holding D values), as
    the JAX package's compiled AQT quantizes: each step rounded to D, the
    scale's product in fp32."""
    absmax = rows.abs().amax(dim=1)
    absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    absmax = absmax.float()
    scale = (absmax * torch.full_like(absmax, INV_EDGE)).to(rows.dtype)
    inv = torch.reciprocal(scale)
    inv = torch.where(torch.isinf(inv), torch.ones_like(inv), inv)
    q = torch.clamp(rows * inv[:, None], -QMAX, QMAX).round()
    return q.to(torch.int8), scale.float()


_QUANT_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def quantize_rows(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row abs-max quantization of ``rows`` [R, L] (fp32 or bf16,
    contiguous) to int8 and fp32 scales; by the CUDA kernel for a CUDA
    tensor."""
    global quantize_launches
    if rows.ndim != 2:
        raise ValueError(f"quantize takes [R, L], got {tuple(rows.shape)}")
    if rows.dtype not in DTYPES:
        raise TypeError(f"quantize takes fp32 or bf16, got {rows.dtype}")
    if rows.device.type == "cpu":
        return quantize_rows_plain(rows)
    if rows.device.type != "cuda":
        raise ValueError(f"quantize kernel: unsupported device {rows.device}")
    if not rows.is_contiguous():
        raise ValueError("quantize kernel takes contiguous rows")
    r, n = rows.shape
    if r > 65535:
        raise ValueError(f"quantize kernel takes at most 65535 rows, got {r}")
    q = torch.empty((r, n), dtype=torch.int8, device=rows.device)
    scale = torch.empty((r,), dtype=torch.float32, device=rows.device)
    if r == 0 or n == 0:
        scale.fill_(INV_EDGE)
        return q, scale
    parts = -(-n // CHUNK)
    partial = torch.empty((r, parts), dtype=torch.float32,
                          device=rows.device)
    fn = build.function("int8_quant", "salt_int8_quant", _QUANT_ARGTYPES)
    with torch.cuda.device(rows.device):
        rc = fn(rows.data_ptr(), partial.data_ptr(), q.data_ptr(),
                scale.data_ptr(), n, r, parts, CHUNK,
                int(rows.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quantize kernel launch failed: cudaError {rc}")
    quantize_launches += 1
    costs.record("int8_quant", r * n, r * n * (rows.element_size() + 1)
                 + 4 * r, costs.FP32_FLOPS, rows.shape)
    return q, scale


# -- the conv ------------------------------------------------------------------
def int8_conv2d_plain(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                      sw: torch.Tensor, stride: _Pair = 1,
                      padding: _Pair = 0, groups: int = 1,
                      out_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """The int8 conv in plain PyTorch: ``F.conv2d`` in float64 over the
    integer values (exact: every sum is an integer under 2^53), then
    ``(float32(acc) * sx[b]) * sw[o]`` in fp32, rounded to
    ``out_dtype``."""
    acc = F.conv2d(xq.double(), wq.double(), None, stride, padding, 1,
                   groups)
    y = acc.float() * sx.float()[:, None, None, None]
    return (y * sw.float()[None, :, None, None]).to(out_dtype)


_CONV_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 15 + [
    ctypes.c_void_p]
_WGMMA_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
    ctypes.c_void_p]


def conv_geometry(x_shape, w_shape, stride: _Pair, padding: _Pair,
                  groups: int):
    """(out_h, out_w, K, vector) of the conv, raising where the kernel
    cannot take it: K = KH KW C_in / groups; ``vector`` when C_in / groups
    and C_in are multiples of 16 (16-byte loads; else the byte gather,
    which holds K up to :data:`GATHER_K`)."""
    b, c, h, w = x_shape
    o, cg, kh, kw = w_shape
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    if groups < 1 or c % groups or o % groups or cg != c // groups:
        raise ValueError(f"int8 conv: x {tuple(x_shape)}, w "
                         f"{tuple(w_shape)}, groups {groups}")
    if min(sh, sw) < 1 or min(ph, pw) < 0:
        raise ValueError(f"int8 conv: stride {stride}, padding {padding}")
    out_h = (h + 2 * ph - kh) // sh + 1
    out_w = (w + 2 * pw - kw) // sw + 1
    k = kh * kw * cg
    vector = cg % 16 == 0 and c % 16 == 0
    if not vector and -(-k // 32) * 32 > GATHER_K:
        raise ValueError(f"int8 conv: K {k} with C_in / groups {cg} is over "
                         f"the gather table's {GATHER_K}")
    return out_h, out_w, k, vector


def conv_path(x_shape, w_shape, stride: _Pair, padding: _Pair,
              groups: int) -> str:
    """The kernel that takes a conv on the card: "wgmma"
    (``csrc/int8_conv_wgmma.cu``) for a 3x3 kernel, stride 1, padding 1,
    groups 1, C_in a multiple of 64 and O of 8 (its tensor maps' 16-byte
    rows); "mma" (``csrc/int8_conv.cu``) for every other geometry."""
    c, (o, _, kh, kw) = x_shape[1], w_shape
    if ((kh, kw) == (3, 3) and _pair(stride) == (1, 1)
            and _pair(padding) == (1, 1) and groups == 1 and c % 64 == 0
            and o % 8 == 0):
        return "wgmma"
    return "mma"


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def wgmma_tile(h: int, w: int) -> Tuple[int, int, int]:
    """(tile_w, tile_h, tile_b) of the wgmma kernel's 256-pixel tiles on
    an h x w map: tile_w the power of two from 8 to 64 that covers w,
    tile_h the rows (at least 4, 8 at tile_w 8: a unit of 64 pixels is
    whole rows of one image), tile_b whole images where one tile holds
    several (four 8x8 images), so the slab stays within
    :data:`WGMMA_SLAB_PIXELS`."""
    tw = min(64, max(8, _pow2_at_least(w)))
    th = min(WGMMA_TILE_PIXELS // tw,
             max(_pow2_at_least(h), 8 if tw == 8 else 4))
    return tw, th, WGMMA_TILE_PIXELS // (tw * th)


@functools.lru_cache(maxsize=1024)
def _conv_plan(x_shape: Tuple[int, ...], w_shape: Tuple[int, ...],
               stride: Tuple[int, int], padding: Tuple[int, int],
               groups: int) -> Tuple[int, int, str, Optional[tuple]]:
    """(out_h, out_w, :func:`conv_path`'s path, the wgmma kernel's tile or
    None) of one geometry; it raises as :func:`conv_geometry` does. Kept
    per geometry: a forward asks the same few dozen again and again."""
    out_h, out_w, _, _ = conv_geometry(x_shape, w_shape, stride, padding,
                                       groups)
    route = conv_path(x_shape, w_shape, stride, padding, groups)
    tile = wgmma_tile(x_shape[2], x_shape[3]) if route == "wgmma" else None
    return out_h, out_w, route, tile


def int8_conv2d(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                sw: torch.Tensor, stride: _Pair = 1, padding: _Pair = 0,
                groups: int = 1, out_dtype: torch.dtype = torch.float32,
                path: Optional[str] = None) -> torch.Tensor:
    """The dequantized conv of int8 ``xq`` [B, C, H, W] (scales ``sx``
    [B]) by int8 ``wq`` [O, C / groups, KH, KW] (scales ``sw`` [O]),
    zero padding, in ``out_dtype`` (fp32 or bf16); by a CUDA kernel for
    a CUDA tensor: ``xq`` in channels_last memory (NHWC bytes), ``wq``
    with its channels innermost (``wq.permute(0, 2, 3, 1)`` contiguous),
    the output channels_last. ``path`` None takes :func:`conv_path`'s
    kernel; "mma" forces ``csrc/int8_conv.cu``, which takes every
    geometry (the A/B of ``chip_smoke.py``)."""
    global conv_launches, wgmma_launches, mma_launches
    if xq.ndim != 4 or wq.ndim != 4:
        raise ValueError(f"int8 conv takes x [B, C, H, W] and w "
                         f"[O, C/g, KH, KW], got {tuple(xq.shape)} and "
                         f"{tuple(wq.shape)}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8 conv takes int8, got {xq.dtype}, {wq.dtype}")
    if out_dtype not in DTYPES:
        raise TypeError(f"int8 conv writes fp32 or bf16, not {out_dtype}")
    stride, padding = _pair(stride), _pair(padding)
    out_h, out_w, route, tile = _conv_plan(tuple(xq.shape), tuple(wq.shape),
                                           stride, padding, groups)
    b, c, h, w = xq.shape
    o, _, kh, kw = wq.shape
    if tuple(sx.shape) != (b,) or tuple(sw.shape) != (o,):
        raise ValueError(f"int8 conv scales {tuple(sx.shape)} and "
                         f"{tuple(sw.shape)} for B {b}, O {o}")
    if path not in (None, "mma"):
        raise ValueError(f"int8 conv: path {path!r}: None (conv_path's "
                         f"kernel) or 'mma'")
    route = path or route
    if xq.device.type == "cpu":
        return int8_conv2d_plain(xq, sx, wq, sw, stride, padding, groups,
                                 out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"int8 conv kernel: unsupported device {xq.device}")
    if any(t.device != xq.device for t in (sx, wq, sw)):
        raise ValueError("int8 conv kernel: operands on different devices")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError("int8 conv kernel takes fp32 scales")
    if not (xq.is_contiguous(memory_format=torch.channels_last)
            and wq.permute(0, 2, 3, 1).is_contiguous()
            and sx.is_contiguous() and sw.is_contiguous()):
        raise ValueError("int8 conv kernel takes x channels_last and w "
                         "[O, KH, KW, C/g] contiguous")
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("int8 conv kernel takes operands aligned to 16 "
                         "bytes")
    if out_h < 1 or out_w < 1 or groups > 65535:
        raise ValueError(f"int8 conv kernel: output {out_h}x{out_w}, "
                         f"groups {groups}")
    out = torch.empty((b, o, out_h, out_w), dtype=out_dtype,
                      device=xq.device, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    bf16 = int(out_dtype == torch.bfloat16)
    # the device by its index: torch's lookup of the current device costs
    # more host time than a small conv's kernel
    idx = xq.device.index
    with torch.cuda.device(idx):
        stream = torch.cuda.current_stream(idx).cuda_stream
        if route == "wgmma":
            fn = build.function("int8_conv_wgmma", "salt_int8_conv_wgmma",
                                _WGMMA_ARGTYPES)
            rc = fn(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(),
                    sw.data_ptr(), out.data_ptr(), b, h, w, c, o, *tile,
                    bf16, stream)
        else:
            (sh, sw_), (ph, pw) = stride, padding
            fn = build.function("int8_conv", "salt_int8_conv",
                                _CONV_ARGTYPES)
            rc = fn(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(),
                    sw.data_ptr(), out.data_ptr(), b, h, w, c, out_h, out_w,
                    o, kh, kw, sh, sw_, ph, pw, groups, bf16, stream)
    if rc != 0:
        raise RuntimeError(f"int8 conv kernel ({route}) launch failed: "
                           f"cudaError {rc}")
    conv_launches += 1
    costs.record("int8_conv_" + route,
                 2 * b * out_h * out_w * o * kh * kw * (c // groups),
                 b * c * h * w + wq.numel() + 4 * (b + o)
                 + out.numel() * out.element_size(), costs.INT8_DENSE_OPS,
                 xq.shape)
    if route == "wgmma":
        wgmma_launches += 1
    else:
        mma_launches += 1
    return out


def quantize_activation(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, C, H, W] in D -> (int8 [B, C, H, W], fp32 [B]): one scale per
    image. On the card the rows are the images' NHWC bytes (x is made
    channels_last first) and the values come out channels_last."""
    b, c, h, w = x.shape
    if x.device.type == "cuda":
        x = x.contiguous(memory_format=torch.channels_last)
    q, s = quantize_rows(x.permute(0, 2, 3, 1).reshape(b, -1))
    return q.view(b, h, w, c).permute(0, 3, 1, 2), s


def quantize_weight(weight: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[O, C / g, KH, KW] in D -> (int8 of the same shape with its
    channels innermost, fp32 [O]): one scale per output channel."""
    o, cg, kh, kw = weight.shape
    q, s = quantize_rows(weight.permute(0, 2, 3, 1).reshape(o, -1))
    return q.view(o, kh, kw, cg).permute(0, 3, 1, 2), s


def conv2d_int8(x: torch.Tensor, weight: torch.Tensor, stride: _Pair = 1,
                padding: _Pair = 0, groups: int = 1) -> torch.Tensor:
    """One AQT int8 conv: both operands quantized per call (per image,
    per output channel), the int8 conv, the result in ``x``'s dtype."""
    if weight.dtype != x.dtype:
        raise TypeError(f"int8 conv: x {x.dtype}, weight {weight.dtype}")
    xq, sx = quantize_activation(x)
    wq, sw = quantize_weight(weight)
    return int8_conv2d(xq, sx, wq, sw, stride, padding, groups, x.dtype)
