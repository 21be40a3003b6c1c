"""Wrapper of the fused preprocess CUDA kernel (``csrc/preprocess.cu``).

Counterpart of ``salt_tpu/ops/pallas_preprocess.py``: uint8 [B, 101, 101]
-> [B, 128, 128, 3] normalized gray + depth channels in one pass, the
edge-pad 101 -> 128 production geometry only.

- A tensor on the CPU takes the plain version,
  ``ops.preprocess.preprocess_inference(pad_method="edge")``.
- A CUDA tensor launches the kernel on the current stream or raises:
  there is no fallback. It must be a contiguous uint8 [B, 101, 101].
- ``launches`` counts kernel launches, and nothing else.

The result is NHWC; ``.permute(0, 3, 1, 2)`` gives the [B, 3, 128, 128]
channels_last view the model reads, without a copy.
"""
from __future__ import annotations

import ctypes

import torch

from salt_tpu_torch.ops import build
from salt_tpu_torch.ops.preprocess import preprocess_inference

RAW = 101
NET = 128

#: kernel launches since the last reset (set it to 0 to reset)
launches = 0

_OUT_DTYPES = (torch.bfloat16, torch.float32)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def preprocess_inference_kernel(images_u8: torch.Tensor,
                                out_dtype: torch.dtype = torch.bfloat16
                                ) -> torch.Tensor:
    """uint8 [B, 101, 101] -> [B, 128, 128, 3] in ``out_dtype`` (bf16 or
    fp32), by the CUDA kernel for a CUDA tensor."""
    global launches
    if images_u8.device.type == "cpu":
        return preprocess_inference(images_u8, "edge", out_dtype)
    if images_u8.device.type != "cuda":
        raise ValueError(f"preprocess kernel: unsupported device "
                         f"{images_u8.device}")
    if images_u8.dtype != torch.uint8:
        raise TypeError(f"preprocess kernel takes uint8, got {images_u8.dtype}")
    if images_u8.ndim != 3 or tuple(images_u8.shape[1:]) != (RAW, RAW):
        raise ValueError(f"preprocess kernel takes [B, {RAW}, {RAW}], got "
                         f"{tuple(images_u8.shape)}")
    if not images_u8.is_contiguous():
        raise ValueError("preprocess kernel takes a contiguous tensor")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"preprocess kernel writes bf16 or fp32, not "
                        f"{out_dtype}")
    b = images_u8.shape[0]
    out = torch.empty((b, NET, NET, 3), dtype=out_dtype,
                      device=images_u8.device)
    if b == 0:
        return out
    fn = build.function("preprocess", "salt_preprocess_inference", _ARGTYPES)
    with torch.cuda.device(images_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(images_u8.data_ptr(), out.data_ptr(), b,
                int(out_dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"preprocess kernel launch failed: cudaError {rc}")
    launches += 1
    return out
