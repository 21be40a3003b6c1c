"""Plain PyTorch versions of the conv and matmul probe kernels, and the
probes' packing helpers (counterpart of ``tools/pallas_conv.py`` :31-112
and ``tools/pallas_conv2.py`` :31-50).

The probes keep the JAX layouts exactly, as contiguous tensors:

- conv128: ``x_padded`` NHWC [B, H+2, W+WPAD, C], ``w_flat`` [9C, F] with
  K index ``(ky*3 + kx)*C + ci``; a VALID 3x3 conv of ``x[:, :, :W+2]``
  -> [B, H, W, F]. The columns past W+2 are never read.
- conv64p: ``x_packed`` [B, H+2, P, 128] with P = (W+WPAD2)/2 (two
  adjacent pixels' 64 channels share one 128-wide row: a free reshape of
  NHWC memory), ``w_packed`` [768, 128] -> [B, H, W/2, 128]. Output pair
  (b, h, p) is one [1, 768] x [768, 128] product whose 768 are 3 rows x
  pixels 2p..2p+3 x 64 channels, i.e. packed columns p and p+1 of input
  rows h..h+2. Every one of the 768 weight rows takes part, the
  "structural zero" slots of :func:`pack_pair_weights` included.
- matmul: row-major [M, K] x [K, N].

Each plain version computes in fp32 with TF32 and autocast off and casts
to the input's dtype; int8 operands give the exact int32 sum through fp32
(every partial sum is an integer below 768 * 128^2 < 2^24) rounded once
to bf16, as the int8 probe returns. The CPU tests and the card's
comparisons use them; no main path calls them on the card.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

WPAD = 8      # conv128 input width W+2 -> W+8
WPAD2 = 16    # conv64p input width W+2 -> W+16 (P = (W+16)/2 packed columns)
PAIR_K = 768  # conv64p window: 3 rows x 4 pixels x 64 channels


def pack_pairs(x):
    """[B, Hp, Wp, 64] -> [B, Hp, Wp/2, 128]: the channels of an adjacent
    pixel pair share one row (same memory; numpy array or tensor)."""
    b, hp, wp, c = x.shape
    return x.reshape(b, hp, wp // 2, 2 * c)


def pack_pair_weights(w) -> np.ndarray:
    """w [3, 3, 64, 64] (HWIO) -> fp32 [768, 128]: rows (ky, px 0..3, ci),
    columns (even-output f | odd-output f). The even output of a pair reads
    window pixels 0..2 with tap kx = px, the odd output pixels 1..3 with
    tap kx = px - 1; the other slots are zero."""
    w = np.asarray(w, np.float32)
    c, f = w.shape[2], w.shape[3]
    wp = np.zeros((3 * 4 * c, 2 * f), np.float32)
    for ky in range(3):
        for px in range(4):
            r0 = (ky * 4 + px) * c
            if px <= 2:
                wp[r0:r0 + c, :f] = w[ky, px]
            if px >= 1:
                wp[r0:r0 + c, f:] = w[ky, px - 1]
    return wp


@contextlib.contextmanager
def exact_fp32(device_type: str):
    """fp32 arithmetic as written: TF32 off for matmuls and cuDNN, autocast
    off."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.autocast(device_type, enabled=False):
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def on_card(name: str, x: torch.Tensor, x_shape, w: torch.Tensor, w_shape,
            dtypes, cpu_dtypes=()) -> bool:
    """Check a probe wrapper's operands; True where the kernel launches (a
    CUDA tensor), False where the plain version runs (a CPU tensor).
    Raises on a wrong shape or device, on a dtype pair outside ``dtypes``
    (on the CPU also ``cpu_dtypes``), on a tensor that requires grad, and
    on the card on non-contiguous or unaligned memory. A None in a shape
    matches any size."""
    for t, shape, what in ((x, x_shape, "x"), (w, w_shape, "w")):
        if t.ndim != len(shape) or any(s is not None and s != d
                                       for s, d in zip(shape, t.shape)):
            raise ValueError(f"{name}: {what} {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(f"{name} is inference-only: call it under "
                           "torch.no_grad()")
    if x.device.type not in ("cpu", "cuda") or w.device != x.device:
        raise ValueError(f"{name}: unsupported device {x.device} / {w.device}")
    card = x.device.type == "cuda"
    allowed = tuple(dtypes) + (() if card else tuple(cpu_dtypes))
    if (x.dtype, w.dtype) not in allowed:
        raise TypeError(f"{name} takes {allowed} on {x.device.type}, got "
                        f"{(x.dtype, w.dtype)}")
    if card and not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if card and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError(f"{name} takes tensors aligned to 16 bytes")
    return card


def _out_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.bfloat16 if dtype == torch.int8 else dtype


def conv128_plain(x_padded: torch.Tensor, w_flat: torch.Tensor, H: int,
                  W: int) -> torch.Tensor:
    """VALID 3x3 conv of ``x_padded[:, :, :W+2]`` [B, H+2, >=W+2, C] by
    ``w_flat`` [9C, F] -> [B, H, W, F] in ``x_padded``'s dtype."""
    c = x_padded.shape[-1]
    f = w_flat.shape[-1]
    with exact_fp32(x_padded.device.type):
        x = x_padded[:, :H + 2, :W + 2, :].float().permute(0, 3, 1, 2)
        w = w_flat.float().reshape(3, 3, c, f).permute(3, 2, 0, 1)
        y = F.conv2d(x, w)
    return y.permute(0, 2, 3, 1).contiguous().to(_out_dtype(x_padded.dtype))


def conv64p_plain(x_packed: torch.Tensor, w_packed: torch.Tensor, H: int,
                  W: int) -> torch.Tensor:
    """The pair-packed conv: [B, H+2, P, 128] x [768, 128] ->
    [B, H, W/2, 128], the full K = 768 window product of each output pair;
    bf16 (or fp32) in -> the same out, int8 in -> bf16 of the exact int32
    sum."""
    po = W // 2
    with exact_fp32(x_packed.device.type):
        x = x_packed.float()
        cols = torch.cat([x[:, ky:ky + H, q:q + po, :]
                          for ky in range(3) for q in range(2)], dim=-1)
        y = cols @ w_packed.float()
    return y.to(_out_dtype(x_packed.dtype))


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] x [K, N] in fp32 -> ``a``'s dtype."""
    with exact_fp32(a.device.type):
        y = a.float() @ b.float()
    return y.to(_out_dtype(a.dtype))
