"""The 3x3 stride-1 convolution C -> 64 of the pair-packed conv kernel, in
plain PyTorch, and the dispatch that routes a model's eligible convs to
the kernel (counterpart of ``salt_tpu/ops/pallas_conv.py``:
``conv3x3_pair`` :150-178, ``make_pallas_conv_fn`` :181-267).

Layout is the port's: NCHW tensors (channels_last memory on the card),
OIHW weights.

- :func:`conv3x3_pair` is the plain version: ``F.conv2d`` on fp32 copies
  with TF32 off, cast back to ``x``'s dtype. The CPU tests and the card's
  comparison use it; the card's main path does not.
- :func:`make_conv_fn` returns an ``F.conv2d``-compatible callable that
  sends every eligible call to ``ops.conv_kernel.conv3x3_pair_kernel``
  (the CUDA kernel on the card, this plain version on the CPU) and
  returns exactly what ``F.conv2d`` returns for every other call.
  Geometry and dtype decide the route, and an A/B scope may narrow it to
  one resolution band; nothing falls back on failure.

Eligible (the JAX dispatch's rules): weight [64, 64, 3, 3], no bias,
stride 1, dilation 1, groups 1, padding (1, 1) ("SAME") or (0, 0)
(VALID on a 1-px halo the caller added), output H and W >= 32 with W
even, computed in bf16: the input's dtype, or under ``torch.autocast``
the autocast dtype that ``F.conv2d`` would cast to, so validation under
autocast routes the same convs as bf16 serving (a routed call casts
input and weight to it, as the JAX dispatch casts the weight).
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F

#: output channels of the kernel (the decoder's and head's width)
FEATURES = 64
#: below 32x32 the convs are too small to be worth a kernel
MIN_RES = 32
#: the A/B scopes of :func:`make_conv_fn`, and the variable it reads
SCOPES = ("all", "res64", "res128")
SCOPE_ENV = "SALT_TPU_PALLAS_CONV_SCOPE"

_Pair = Union[int, Sequence[int]]


def _pair(v: _Pair):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv3x3_pair(x: torch.Tensor, w: torch.Tensor,
                 halo: bool = False) -> torch.Tensor:
    """3x3 stride-1 conv of ``x`` [B, C, H, W] by ``w`` [64, C, 3, 3]:
    zero SAME padding, or with ``halo=True`` a VALID conv of ``x``
    [B, C, H+2, W+2] that carries its own 1-px ring. fp32 arithmetic
    (TF32 and autocast off), result [B, 64, H, W] in ``x``'s dtype."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.autocast(x.device.type, enabled=False):
            y = F.conv2d(x.float(), w.float(), padding=0 if halo else 1)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return y.to(x.dtype)


def route(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor], stride: _Pair, padding: _Pair,
          dilation: _Pair, groups: int,
          dtype: Optional[torch.dtype] = None) -> Optional[bool]:
    """``halo`` (False for SAME, True for VALID) when the conv, computed
    in ``dtype`` (default ``x``'s), is one the kernel computes, else
    None."""
    if (x.ndim != 4 or bias is not None or groups != 1
            or isinstance(padding, str)
            or tuple(weight.shape) != (FEATURES, FEATURES, 3, 3)
            or x.shape[1] != FEATURES or _pair(stride) != (1, 1)
            or _pair(dilation) != (1, 1)
            or (dtype or x.dtype) != torch.bfloat16):
        return None
    pad = _pair(padding)
    if pad not in ((1, 1), (0, 0)):
        return None
    halo = pad == (0, 0)
    h, w = (x.shape[2] - 2, x.shape[3] - 2) if halo else x.shape[2:]
    if h < MIN_RES or w < MIN_RES or w % 2:
        return None
    return halo


def in_scope(scope: str, out_h: int) -> bool:
    """The A/B scope's output-height rule (``salt_tpu/ops/pallas_conv.py``
    :237-247): "res64" keeps the convs of output height <= 64, "res128"
    those >= 128, "all" every one."""
    return not ((scope == "res64" and out_h > 64)
                or (scope == "res128" and out_h < 128))


def make_conv_fn(scope: Optional[str] = None) -> Callable[..., torch.Tensor]:
    """The ``F.conv2d``-compatible callable of ``model.pallas_conv`` "on"
    and "auto". ``scope`` ("all", "res64" or "res128"; :data:`SCOPES`)
    restricts the kernel to one resolution band, as the JAX package's
    ``SALT_TPU_PALLAS_CONV_SCOPE`` does for its A/B harness; None reads
    that variable once, here (unset: "all")."""
    from salt_tpu_torch.ops import conv_kernel
    if scope is None:
        scope = os.environ.get(SCOPE_ENV, "all")
    if scope not in SCOPES:
        raise ValueError(f"conv scope {scope!r}: expected one of {SCOPES}")

    def conv_fn(x, weight, bias=None, stride=1, padding=0, dilation=1,
                groups=1):
        dtype = (torch.get_autocast_dtype(x.device.type)
                 if torch.is_autocast_enabled(x.device.type) else x.dtype)
        halo = route(x, weight, bias, stride, padding, dilation, groups,
                     dtype)
        if halo is not None and not in_scope(scope,
                                             x.shape[2] - 2 * halo):
            halo = None
        if halo is None:
            return F.conv2d(x, weight, bias, stride, padding, dilation,
                            groups)
        xc = x.to(dtype).contiguous(memory_format=torch.channels_last)
        return conv_kernel.conv3x3_pair_kernel(xc, weight.to(dtype),
                                               halo=halo)

    return conv_fn
