"""The yardstick's peaks and the work of each kernel, from the cell's
shapes alone (frozen from the program's ``ops/costs.py`` formulas,
which the benchmark does not import).

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit.
A bound counts each input byte read once and each output byte written
once; a kernel's least time is the larger of its bytes at the memory
rate and its operations at its rate; a row of kernels' bound is the sum
of theirs.
"""
from __future__ import annotations

from typing import List

import torch

from benchmark import reference
from benchmark.reference import quant

HBM_BYTES_PER_S = 3.35e12
BF16_DENSE_FLOPS = 989e12
INT8_DENSE_OPS = 1979e12
FP32_FLOPS = 67e12

RAW = 101
NET = 128


def bound_s(nbytes: float, operations: float = 0.0,
            ops_per_s: float = 1.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, operations / ops_per_s)


def preprocess_s(images: int) -> float:
    """Row 1 over ``images``: uint8 101x101 in, bf16 128x128x3 out; six
    fp32 operations a pixel."""
    return bound_s(images * (RAW * RAW + NET * NET * 3 * 2),
                   images * NET * NET * 6, FP32_FLOPS)


def sort_s(rows: int, length: int) -> float:
    """Row 2, one call: fp32 keys and int32 payload in and out; the
    network's compare-exchanges."""
    log = length.bit_length() - 1
    return bound_s(rows * length * (4 + 4) * 2,
                   rows * log * (log + 1) // 2 * length // 2, FP32_FLOPS)


def conv_ops(site: quant.Site) -> int:
    b, _, _, _ = site.x_shape
    o, cg, kh, kw = site.w_shape
    ho, wo = site.out_hw
    return 2 * b * ho * wo * o * cg * kh * kw


def row3_s(site: quant.Site) -> float:
    """Row 3 (bf16 3x3 64 -> 64): bf16 in and weight, bf16 out."""
    b, c, h, w = site.x_shape
    o = site.w_shape[0]
    ho, wo = site.out_hw
    nbytes = 2 * (b * c * h * w + o * c * 9 + b * o * ho * wo)
    return bound_s(nbytes, conv_ops(site), BF16_DENSE_FLOPS)


def int8_quant_s(site: quant.Site) -> float:
    """Row 8 of one int8 conv: both bf16 operands read, s8 written (and
    an fp32 scale a row)."""
    xn = 1
    for d in site.x_shape:
        xn *= d
    wn = 1
    for d in site.w_shape:
        wn *= d
    rows = site.x_shape[0] + site.w_shape[0]
    return bound_s((xn + wn) * (2 + 1) + rows * 4)


def int8_conv_s(site: quant.Site) -> float:
    """Row 9 of one int8 conv: s8 operands in, bf16 out; 2 M N K at the
    int8 peak."""
    b = site.x_shape[0]
    xn = 1
    for d in site.x_shape:
        xn *= d
    wn = 1
    for d in site.w_shape:
        wn *= d
    ho, wo = site.out_hw
    nbytes = xn + wn + 2 * b * site.w_shape[0] * ho * wo
    return bound_s(nbytes, conv_ops(site), INT8_DENSE_OPS)


def forward_sites(cfg: dict, batch: int, quant_bits: int,
                  pallas_conv: str) -> List[quant.Site]:
    """Every conv call of one infer-form forward of the configuration's
    reference model at ``batch`` images of 128x128, on the meta device."""
    sites: List[quant.Site] = []
    with torch.device("meta"):
        model = reference.for_config(cfg).build(cfg)
        x = torch.empty(batch, 3, NET, NET)
    model(x, quant.conv_policy(quant_bits, pallas_conv, sites))
    return sites
