"""Launcher of the VALID-conv CUDA kernel (``csrc/conv_valid.cu``), which
rows 4 and 5 of the probe kernels share: ``ops.conv128_kernel`` (KW 3)
and ``ops.conv64p_kernel.make_conv64p_kernel`` (KW 2 over packed
columns). Their wrappers check the operands and count launches; the plain
version of the function is ``ops.probe_conv.valid_conv_plain``."""
from __future__ import annotations

import ctypes

import torch

from salt_tpu_torch.ops import build

#: salt_conv_valid(x, w, y, batch, out_h, out_w, kw, channels, filters,
#: row_pixels, stream)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def launch(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, kw: int,
           row_pixels: int) -> None:
    """Launch the kernel on the current stream: x [B, out_h+2, row_pixels,
    C], w [3 kw C, F], out [B, out_h, out_w, F], bf16, contiguous and on
    one card (the callers check). Raises where the launch is refused."""
    b, out_h, out_w, f = out.shape
    fn = build.function("conv_valid", "salt_conv_valid", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, out_h, out_w,
                kw, x.shape[-1], f, row_pixels,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv_valid kernel launch failed: cudaError {rc}")
