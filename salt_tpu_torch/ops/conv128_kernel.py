"""Row 4, the im2col conv, on the VALID-conv kernel (``csrc/conv_valid.cu``).

Counterpart of ``tools/pallas_conv.py::make_conv128_kernel`` (:35-88): the
factory returns a callable ``(x_padded, w_flat) -> out``, x_padded [B, H+2,
W+8, C] (C a multiple of 128), w_flat [9C, F] with K index
``(ky*3 + kx)*C + ci``, out [B, H, W, F] = the VALID 3x3 conv of
``x_padded[:, :, :W+2]``.

- A tensor on the CPU takes the plain version, ``ops.probe_conv.conv128_plain``.
- A CUDA tensor launches the kernel on the current stream or raises: bf16,
  contiguous, 16-byte aligned, F a multiple of 64 (the kernel's column
  tile). There is no fallback.
- ``launches`` counts kernel launches, and nothing else.

The kernel takes ``w_flat`` as it is (its wgmma reads the weights N-major)
and reads ``x_padded`` at columns < W+2 of its W+8-pixel rows. It picks
its own tile (4 rows x 64 pixels); ``tile_h`` is checked, as the TPU
kernel's contract, and does not reach the card.
"""
from __future__ import annotations

import torch

from salt_tpu_torch.ops import conv_valid
from salt_tpu_torch.ops.probe_conv import WPAD, conv128_plain, on_card

#: kernel launches since the last reset (set it to 0 to reset)
launches = 0


def make_conv128_kernel(tile_h: int, H: int, W: int, C: int, F: int):
    """Row 4: the im2col conv, bf16 on the card (fp32 on the CPU too)."""
    if C < 128 or C % 128:
        raise ValueError(f"im2col conv takes C a multiple of 128, got {C}")
    if F < 64 or F % 64:
        raise ValueError(f"im2col conv takes F a multiple of 64, got {F}")
    if W < 1 or tile_h < 1 or H < 1 or H % tile_h:
        raise ValueError(f"im2col conv: H = {H} is not a multiple of tile_h "
                         f"= {tile_h} (the tail rows would be undefined)")
    x_shape = (None, H + 2, W + WPAD, C)

    def conv(x_padded: torch.Tensor, w_flat: torch.Tensor) -> torch.Tensor:
        global launches
        if not on_card("conv128", x_padded, x_shape, w_flat, (9 * C, F),
                       ((torch.bfloat16, torch.bfloat16),),
                       ((torch.float32, torch.float32),)):
            return conv128_plain(x_padded, w_flat, H, W)
        b = x_padded.shape[0]
        out = torch.empty((b, H, W, F), dtype=torch.bfloat16,
                          device=x_padded.device)
        if b == 0:
            return out
        conv_valid.launch(x_padded, w_flat, out, 3, W + WPAD)
        launches += 1
        return out

    return conv
