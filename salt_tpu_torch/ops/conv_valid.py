"""Launcher of the VALID-conv CUDA kernel (``csrc/conv_valid.cu``), which
rows 4, 5 and 7 of the probe kernels share: ``ops.conv128_kernel`` (KW 3)
and ``ops.conv64p_kernel``'s ``make_conv64p_kernel`` and
``make_conv64p_v2`` (KW 2 over packed columns; row 7 in bf16 or int8).
Their wrappers check the operands and count launches; the plain version
of the function is ``ops.probe_conv.valid_conv_plain``."""
from __future__ import annotations

import ctypes

import torch

from salt_tpu_torch.ops import build

#: salt_conv_valid[_s8](x, w, y, batch, out_h, out_w, kw, channels,
#: filters, row_pixels, stream)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def kmajor_weights(w_flat: torch.Tensor) -> torch.Tensor:
    """w_flat [K, F] -> its K-major copy [F, K] (contiguous), the weight
    operand of the int8 kernel: wgmma takes 8-bit B K-major only."""
    return w_flat.t().contiguous()


def launch(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, kw: int,
           row_pixels: int) -> None:
    """Launch the kernel on the current stream: x [B, out_h+2, row_pixels,
    C], out [B, out_h, out_w, F] bf16; bf16 x with w [3 kw C, F], or int8 x
    with w the K-major int8 copy [F, 3 kw C] (:func:`kmajor_weights`);
    contiguous and on one card (the callers check). Raises where the
    launch is refused."""
    b, out_h, out_w, f = out.shape
    s8 = x.dtype == torch.int8
    fn = build.function("conv_valid",
                        "salt_conv_valid_s8" if s8 else "salt_conv_valid",
                        _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, out_h, out_w,
                kw, x.shape[-1], f, row_pixels,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv_valid kernel launch failed: cudaError {rc}")
