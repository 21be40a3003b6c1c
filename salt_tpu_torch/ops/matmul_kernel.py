"""Wrapper of the matmul CUDA kernel (``csrc/matmul_wgmma.cu``: TMA +
wgmma, persistent blocks).

Counterpart of ``tools/pallas_conv.py::make_matmul_kernel`` (:173-200):
the factory returns a callable ``(a, b) -> a @ b`` for row-major a [M, K]
and b [K, N], fp32 accumulation, out in a's dtype.

- A tensor on the CPU takes the plain version, ``ops.probe_conv.matmul_plain``.
- A CUDA tensor launches the kernel on the current stream or raises: bf16,
  contiguous, 16-byte aligned, K and N multiples of 64. There is no
  fallback, and cuBLAS is never called.
- ``launches`` counts kernel launches, and nothing else.

The kernel reads a and b as they are (b N-major through wgmma's
transposed B: no transposed copy) and picks its own tile (128 rows x 128
or 64 columns); ``tile_m`` is checked (``M % tile_m``), as the TPU
kernel's contract, and does not reach the card.
"""
from __future__ import annotations

import ctypes

import torch

from salt_tpu_torch.ops import build
from salt_tpu_torch.ops.probe_conv import matmul_plain, on_card

#: kernel launches since the last reset (set it to 0 to reset)
launches = 0

#: salt_matmul_wgmma(a, b, y, m, k, n, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def make_matmul_kernel(M: int, K: int, N: int, tile_m: int = 2048):
    """Row 6: [M, K] x [K, N] over a grid of tile_m rows."""
    if tile_m < 1 or M < 1 or M % tile_m:
        raise ValueError(f"matmul: M = {M} is not a multiple of tile_m = "
                         f"{tile_m} (the tail rows would be undefined)")
    if K < 1 or N < 1:
        raise ValueError(f"matmul: empty K = {K} or N = {N}")

    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        global launches
        if not on_card("matmul", a, (M, K), b, (K, N),
                       ((torch.bfloat16, torch.bfloat16),),
                       ((torch.float32, torch.float32),)):
            return matmul_plain(a, b)
        if K % 64 or N % 64:
            raise ValueError(f"matmul kernel takes K and N multiples of 64, "
                             f"got K = {K}, N = {N}")
        out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
        fn = build.function("matmul_wgmma", "salt_matmul_wgmma", _ARGTYPES)
        with torch.cuda.device(a.device):
            rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
                    torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"matmul kernel launch failed: cudaError {rc}")
        launches += 1
        return out

    return mm
