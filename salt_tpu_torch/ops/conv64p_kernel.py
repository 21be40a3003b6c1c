"""Wrappers of the pair-packed conv CUDA kernel (``csrc/conv64p.cu``).

Counterparts of ``tools/pallas_conv.py::make_conv64p_kernel`` (:115-170)
and ``tools/pallas_conv2.py::make_conv64p_v2`` (:53-168): each factory
returns a callable ``(x_packed, w_packed) -> out`` with x_packed [B, H+2,
(W+16)/2, 128], w_packed [768, 128] and out [B, H, W/2, 128] (pair-packed;
``out.reshape(B, H, W, 64)`` unpacks it).

- A tensor on the CPU takes the plain version, ``ops.probe_conv.conv64p_plain``.
- A CUDA tensor launches the kernel on the current stream or raises: bf16
  (``int8=True``: int8) operands, contiguous and 16-byte aligned. There is
  no fallback.
- ``make_conv64p_v2``'s ``db`` double-buffers the input stages with
  cp.async; ``int8`` takes int8 operands and returns bf16 of the exact
  int32 sum. The Pallas variants' ``shift`` and ``dots`` choose Mosaic's
  data movement and have no counterpart (see the source's note).
- ``launches`` counts launches of row 5 (``make_conv64p_kernel``),
  ``launches_v2`` those of row 7 (``make_conv64p_v2``), and nothing else.

The weights are transposed to [128, 768] with torch on every call (196 KB
in bf16): the kernel reads both operands K-contiguous.
"""
from __future__ import annotations

import ctypes

import torch

from salt_tpu_torch.ops import build
from salt_tpu_torch.ops.probe_conv import (PAIR_K, WPAD2, conv64p_plain,
                                           on_card)

#: launches of make_conv64p_kernel's callables (set it to 0 to reset)
launches = 0
#: launches of make_conv64p_v2's callables (set it to 0 to reset)
launches_v2 = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BF16 = ((torch.bfloat16, torch.bfloat16),)
_INT8 = ((torch.int8, torch.int8),)
_FP32 = ((torch.float32, torch.float32),)


def _geometry(tile_h: int, H: int, W: int, C: int) -> None:
    if C != 64:
        raise ValueError(f"pair-packed conv takes C = 64, got {C}")
    if W < 2 or W % 2:
        raise ValueError(f"pair-packed conv takes an even W, got {W}")
    if tile_h < 1 or H < 1 or H % tile_h:
        raise ValueError(f"pair-packed conv: H = {H} is not a multiple of "
                         f"tile_h = {tile_h} (the tail rows would be "
                         "undefined)")


def _launch(x: torch.Tensor, w: torch.Tensor, H: int, W: int, tile_h: int,
            db: bool, int8: bool) -> torch.Tensor:
    out = torch.empty((x.shape[0], H, W // 2, 128), dtype=torch.bfloat16,
                      device=x.device)
    if x.shape[0] == 0:
        return out
    wt = w.t().contiguous()
    fn = build.function("conv64p", "salt_conv64p", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), wt.data_ptr(), out.data_ptr(), x.shape[0], H,
                W, tile_h, int(db), int(int8),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv64p kernel launch failed: cudaError {rc}")
    return out


def make_conv64p_kernel(tile_h: int, H: int, W: int, C: int = 64):
    """Row 5: the pair-packed conv, bf16 (fp32 on the CPU too), each stage
    loaded and then computed."""
    _geometry(tile_h, H, W, C)
    x_shape = (None, H + 2, (W + WPAD2) // 2, 2 * C)

    def conv(x_packed: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
        global launches
        if on_card("conv64p", x_packed, x_shape, w_packed, (PAIR_K, 2 * C),
                   _BF16, _FP32):
            out = _launch(x_packed, w_packed, H, W, tile_h, False, False)
            if x_packed.shape[0]:
                launches += 1
            return out
        return conv64p_plain(x_packed, w_packed, H, W)

    return conv


def make_conv64p_v2(tile_h: int, H: int, W: int, C: int = 64, *,
                    db: bool = False, int8: bool = False):
    """Row 7: the pair-packed conv with the input stages double-buffered
    (``db``) and/or int8 operands (``int8``); bf16 out."""
    _geometry(tile_h, H, W, C)
    x_shape = (None, H + 2, (W + WPAD2) // 2, 2 * C)
    dtypes = _INT8 if int8 else _BF16

    def conv(x_packed: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
        global launches_v2
        if on_card("conv64p_v2", x_packed, x_shape, w_packed,
                   (PAIR_K, 2 * C), dtypes):
            out = _launch(x_packed, w_packed, H, W, tile_h, db, int8)
            if x_packed.shape[0]:
                launches_v2 += 1
            return out
        return conv64p_plain(x_packed, w_packed, H, W)

    return conv
