"""Wrappers of the pair-packed conv: rows 5 and 7 on the VALID-conv kernel
(``csrc/conv_valid.cu``, through ``ops.conv_valid``).

Counterparts of ``tools/pallas_conv.py::make_conv64p_kernel`` (:115-170)
and ``tools/pallas_conv2.py::make_conv64p_v2`` (:53-168): each factory
returns a callable ``(x_packed, w_packed) -> out`` with x_packed [B, H+2,
(W+16)/2, 128], w_packed [768, 128] and out [B, H, W/2, 128] (pair-packed;
``out.reshape(B, H, W, 64)`` unpacks it). Both compute one function, the
VALID 3x2 conv 128 -> 128 over the packed columns.

- A tensor on the CPU takes the plain version of that function,
  ``ops.probe_conv.valid_conv_plain``.
- A CUDA tensor launches the kernel on the current stream or raises: bf16
  (``make_conv64p_v2(int8=True)``: int8) operands, contiguous and 16-byte
  aligned. There is no fallback. int8 returns bf16 of the exact int32 sum.
- ``launches`` counts launches of row 5 (``make_conv64p_kernel``),
  ``launches_v2`` those of row 7 (``make_conv64p_v2``), and nothing else.

The kernel reads ``x_packed`` at packed columns < W/2 + 1 and picks its
own tile (4 rows x 64 pairs), and its TMA input ring always
double-buffers: ``tile_h`` and row 7's ``db`` are checked or taken as the
TPU kernels' contract and do not reach the card. The Pallas variants'
``shift`` and ``dots`` choose Mosaic's data movement and have no
counterpart. bf16 takes ``w_packed`` as it is; int8 reads the weights
K-major (8-bit wgmma has no transpose), so row 7's int8 path makes that
copy (``conv_valid.kmajor_weights``, 98 KB) on every call.
"""
from __future__ import annotations

import torch

from salt_tpu_torch.ops import conv_valid
from salt_tpu_torch.ops.probe_conv import (PAIR_K, WPAD2, on_card,
                                           valid_conv_plain)

#: launches of make_conv64p_kernel's callables (set it to 0 to reset)
launches = 0
#: launches of make_conv64p_v2's callables (set it to 0 to reset)
launches_v2 = 0

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


def _conv(name: str, H: int, W: int, dtypes, cpu_dtypes=()):
    """A callable ``(x_packed, w_packed) -> (out, kernel launches made: 0
    or 1)`` of a pair-packed conv that takes ``dtypes`` on the card (and
    ``cpu_dtypes`` on the CPU too)."""
    x_shape = (None, H + 2, (W + WPAD2) // 2, 128)

    def conv(x_packed: torch.Tensor, w_packed: torch.Tensor):
        if not on_card(name, x_packed, x_shape, w_packed, (PAIR_K, 128),
                       dtypes, cpu_dtypes):
            return valid_conv_plain(x_packed, w_packed, 3, 2, H, W // 2), 0
        out = torch.empty((x_packed.shape[0], H, W // 2, 128),
                          dtype=torch.bfloat16, device=x_packed.device)
        if not x_packed.shape[0]:
            return out, 0
        if x_packed.dtype == torch.int8:
            w_packed = conv_valid.kmajor_weights(w_packed)
        conv_valid.launch(x_packed, w_packed, out, 2, (W + WPAD2) // 2)
        return out, 1

    return conv


def make_conv64p_kernel(tile_h: int, H: int, W: int, C: int = 64):
    """Row 5: the pair-packed conv, bf16 (fp32 on the CPU too)."""
    _geometry(tile_h, H, W, C)
    run = _conv("conv64p", H, W, _BF16, _FP32)

    def conv(x_packed: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
        global launches
        out, n = run(x_packed, w_packed)
        launches += n
        return out

    return conv


def make_conv64p_v2(tile_h: int, H: int, W: int, C: int = 64, *,
                    db: bool = False, int8: bool = False):
    """Row 7: the pair-packed conv with the input stages double-buffered
    (``db``, as the kernel always does) and/or int8 operands (``int8``);
    bf16 out."""
    _geometry(tile_h, H, W, C)
    run = _conv("conv64p_v2", H, W, _INT8 if int8 else _BF16)

    def conv(x_packed: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
        global launches_v2
        out, n = run(x_packed, w_packed)
        launches_v2 += n
        return out

    return conv
