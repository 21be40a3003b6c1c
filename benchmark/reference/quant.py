"""The served program's conv arithmetic, frozen in plain float32.

Integer quantization as the configuration's ``quant_bits`` states it
(AQT's dynamic symmetric quantization): per call, one scale per image
of the activation (over C, H and W) and one per output channel of the
weight (over C_in, KH and KW); ``scale = absmax * float32(1 / edge)``
with ``edge = 2**(bits-1) - 0.5`` (127.5 at 8 bits) and an absmax of 0
taken as 1; ``q = round_half_even(clip(x * (1 / scale), -qmax, qmax))``
with ``qmax = 2**(bits-1) - 1``; the conv of the integers, times the
image's scale and the channel's. The integer conv runs in float32 with
TF32 off (exact while a sum stays under 2**24, within 1e-7 after).
"fp8" in place of a width rounds each operand to e4m3 (float8_e4m3fn)
with one scale a row, the row's absmax mapped to 448.

:func:`conv_policy` is the configuration's route: with ``pallas_conv``
"on" the 3x3 stride-1 64 -> 64 convs without bias at 32 px and more
(even width) stay in full precision, and with ``quant_bits`` every other
conv site is quantized. ``bits`` below the configuration's gives the
control of a lower precision (4 for an int8 configuration).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def quantize_rows(rows: torch.Tensor, bits: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R, L] fp32 -> (integer values as fp32 [R, L], scales [R]). The
    rounding passes the gradient straight through, and the scales carry
    none (a training control's backward)."""
    qmax = float(2 ** (bits - 1) - 1)
    inv_edge = torch.tensor(1.0 / (qmax + 0.5), dtype=torch.float32).item()
    absmax = rows.detach().abs().amax(dim=1)
    absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    scale = absmax * torch.full_like(absmax, inv_edge)
    q = torch.clamp(rows * torch.reciprocal(scale)[:, None], -qmax, qmax)
    return q + (q.round() - q).detach(), scale


def fp8_rows(rows: torch.Tensor, fmt=torch.float8_e4m3fn
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R, L] fp32 -> (values rounded to ``fmt`` as fp32 [R, L], scales
    [R]): each row scaled so that its absmax is the format's largest
    value (448 in e4m3), rounded to the format, the gradient passed
    straight through."""
    absmax = rows.detach().abs().amax(dim=1)
    absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    scale = absmax / torch.finfo(fmt).max
    v = rows / scale[:, None]
    return v + (v.to(fmt).float() - v).detach(), scale


def quantize(rows: torch.Tensor, bits) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_rows` at ``bits``, or :func:`fp8_rows` for "fp8"."""
    return fp8_rows(rows) if bits == "fp8" else quantize_rows(rows, bits)


def quantized_conv(x, w, bias=None, stride=1, padding=0, dilation=1,
                   groups=1, bits=8) -> torch.Tensor:
    """One quantized conv in fp32, both operands quantized per call
    (``bits`` a width, or "fp8" for e4m3 with a scale a row)."""
    b = x.shape[0]
    o = w.shape[0]
    qx, sx = quantize(x.float().reshape(b, -1), bits)
    qw, sw = quantize(w.float().reshape(o, -1), bits)
    y = F.conv2d(qx.view(x.shape), qw.view(w.shape), None, stride, padding,
                 dilation, groups)
    y = y * sx[:, None, None, None] * sw[None, :, None, None]
    return y if bias is None else y + bias.float()[None, :, None, None]


class _GradientRows(torch.autograd.Function):
    """The identity, whose backward quantizes the incoming gradient per
    image (per row of the batch) to ``bits``."""

    @staticmethod
    def forward(ctx, y, bits):
        ctx.bits = bits
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        b = g.shape[0]
        if ctx.bits == "fp8":
            q, s = fp8_rows(g.reshape(b, -1), torch.float8_e5m2)
        else:
            q, s = quantize_rows(g.reshape(b, -1), ctx.bits)
        return (q * s[:, None]).view_as(g), None


def training_conv(bits) -> Callable:
    """A training step's convs at ``bits`` (a control; "fp8": e4m3
    forward, e5m2 gradients): both operands of the forward quantized as
    the infer form's are, and the gradient arriving at each conv's output
    quantized per image, so both products of its backward take quantized
    operands too."""

    def conv(x, w, bias=None, stride=1, padding=0, dilation=1, groups=1):
        y = quantized_conv(x, w, None, stride, padding, dilation, groups,
                           bits)
        y = _GradientRows.apply(y, bits)
        return y if bias is None else y + bias[None, :, None, None]

    return conv


def full_precision_route(x, w, bias, stride, padding, groups) -> bool:
    """Whether ``pallas_conv`` "on" keeps this conv in full precision:
    3x3, 64 -> 64, stride 1, padding 1, no bias, one group, output at
    least 32x32 with an even width."""
    return (tuple(w.shape) == (64, 64, 3, 3) and x.shape[1] == 64
            and bias is None and groups == 1 and _pair(stride) == (1, 1)
            and _pair(padding) == (1, 1) and x.shape[2] >= 32
            and x.shape[3] >= 32 and x.shape[3] % 2 == 0)


class Site:
    """One conv call's shapes, as :func:`conv_policy` saw it."""

    def __init__(self, x, w, stride, padding, groups, quantized):
        self.x_shape = tuple(x.shape)
        self.w_shape = tuple(w.shape)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.groups = groups
        self.quantized = quantized
        kh, kw = self.w_shape[2:]
        self.out_hw = tuple(
            (n + 2 * p - k) // s + 1 for n, p, k, s in
            zip(self.x_shape[2:], self.padding, (kh, kw), self.stride))
        self.row3 = full_precision_route(x, w, None, stride, padding, groups)


def conv_policy(quant_bits: int, pallas_conv: str,
                sites: Optional[List[Site]] = None) -> Callable:
    """The conv callable of the configuration's infer form: full
    precision, or quantized to ``quant_bits`` at every site but the ones
    ``pallas_conv`` keeps; ``sites`` (when given) records every call."""
    keep = pallas_conv in ("on", "auto")

    def conv(x, w, bias=None, stride=1, padding=0, dilation=1, groups=1):
        quant = bool(quant_bits) and not (
            keep and full_precision_route(x, w, bias, stride, padding,
                                          groups))
        if sites is not None:
            sites.append(Site(x, w, stride, padding, groups, quant))
        if quant:
            return quantized_conv(x, w, bias, stride, padding, dilation,
                                  groups, quant_bits)
        return F.conv2d(x, w, bias, stride, padding, dilation, groups)

    return conv
