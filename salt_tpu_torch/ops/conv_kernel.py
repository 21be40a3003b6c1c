"""Wrapper of the 3x3 conv CUDA kernel (``csrc/conv3x3_pair.cu``).

Counterpart of ``salt_tpu/ops/pallas_conv.py::conv3x3_pair`` (:66-178):
``x`` [B, C, H, W] (or [B, C, H+2, W+2] with ``halo=True``) by ``w``
[64, C, 3, 3] -> [B, 64, H, W], fp32 accumulation, bf16 in and out.

- A tensor on the CPU takes the plain version, ``ops.conv_pair.conv3x3_pair``.
- A CUDA tensor launches the kernel on the current stream or raises: there
  is no fallback. It takes bf16 only, ``x`` in channels_last memory and
  contiguous (NHWC bytes), C a multiple of 16.
- ``launches`` counts kernel launches, and nothing else.
- Inference only, as the JAX kernel is: a call with grad enabled on an
  input that requires grad raises (the train form never calls it).

The weight is repacked from OIHW to the kernel's [64, 3, 3, C]
(``ops.conv_pair.pack_weight``) with one torch copy on every call (73.7 KB
at C = 64), in the span :data:`REPACK_RANGE` (``core/tracing.py``), whose
profiler range lets a trace show the route's whole device cost.
"""
from __future__ import annotations

import ctypes

import torch

from salt_tpu_torch.core.tracing import span
from salt_tpu_torch.ops import build, costs
from salt_tpu_torch.ops.conv_pair import FEATURES, conv3x3_pair, pack_weight

#: kernel launches since the last reset (set it to 0 to reset)
launches = 0
#: the span (and ``torch.profiler`` range) around the weight repack of
#: every launch
REPACK_RANGE = "conv3x3_pair.repack"


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def conv3x3_pair_kernel(x: torch.Tensor, w: torch.Tensor,
                        halo: bool = False) -> torch.Tensor:
    """3x3 stride-1 conv to 64 channels, zero SAME padding or (``halo``)
    VALID; by the CUDA kernel for a CUDA tensor."""
    global launches
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("conv3x3_pair kernel is inference-only: call it "
                           "under torch.no_grad()")
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"conv kernel takes x [B, C, H, W] and w "
                         f"[64, C, 3, 3], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    b, c, hx, wx = x.shape
    if tuple(w.shape) != (FEATURES, c, 3, 3):
        raise ValueError(f"conv kernel takes w [{FEATURES}, {c}, 3, 3], got "
                         f"{tuple(w.shape)}")
    h, wd = (hx - 2, wx - 2) if halo else (hx, wx)
    if h < 1 or wd < 1:
        raise ValueError(f"conv kernel: empty output for x {tuple(x.shape)} "
                         f"halo={halo}")
    if x.device.type == "cpu":
        return conv3x3_pair(x, w, halo)
    if x.device.type != "cuda":
        raise ValueError(f"conv kernel: unsupported device {x.device}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"conv kernel takes bf16, got {x.dtype} and {w.dtype}")
    if c % 16:
        raise ValueError(f"conv kernel takes C a multiple of 16, got {c}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv kernel takes x contiguous in channels_last "
                         "memory (NHWC bytes)")
    if x.data_ptr() % 16:
        raise ValueError("conv kernel takes x aligned to 16 bytes")
    out = torch.empty((b, FEATURES, h, wd), dtype=torch.bfloat16,
                      device=x.device, memory_format=torch.channels_last)
    if b == 0:
        return out
    with span(REPACK_RANGE):
        w_packed = pack_weight(w)
    fn = build.function("conv3x3_pair", "salt_conv3x3_pair", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), w_packed.data_ptr(), out.data_ptr(), b, h, wd,
                c, hx, wx, stream)
    if rc != 0:
        raise RuntimeError(f"conv kernel launch failed: cudaError {rc}")
    launches += 1
    costs.record("conv3x3_pair", 2 * b * h * wd * FEATURES * 9 * c,
                 2 * (b * c * hx * wx + FEATURES * 9 * c
                      + b * FEATURES * h * wd), costs.BF16_DENSE_FLOPS,
                 x.shape)
    return out
