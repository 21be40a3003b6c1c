"""Preprocessing as plain torch: pad / resize / normalize / depth
channels / one-hot targets.

Counterpart of ``salt_tpu/ops/preprocess.py`` (:39-140), with the same
conventions:

- pad/crop asymmetry: for an odd total pad v, top gets floor(v/2) and
  bottom the remainder; left gets the remainder of the horizontal split.
  101 -> 128 pads top 13, bottom 14, left 14, right 13.
- pad methods: 'edge'/'replicate' -> replicate, 'reflect' -> reflect
  (numpy/jnp 'reflect' == torch 'reflect'), 'zero'/'constant' -> zeros.
- normalization: ImageNet mean/std of the gray channel.
- depth channels: ch1 = linspace(0, 1, H) row ramp, ch2 = ch0 * ramp.

Tensors keep the JAX package's layout at these public functions:
``[..., H, W]`` planes in, ``[..., H, W, 3]`` out. ``preprocess_inference``
is also the plain version of the CUDA kernel in ``preprocess_kernel``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN_GRAY = 0.485
IMAGENET_STD_GRAY = 0.229


def get_crop_pad_sequence(vertical: int, horizontal: int
                          ) -> Tuple[int, int, int, int]:
    """(top, right, bottom, left) split of total pad/crop amounts."""
    top = vertical // 2
    bottom = vertical - top
    right = horizontal // 2
    left = horizontal - right
    return top, right, bottom, left


def _pad_mode(method: str) -> str:
    if method in ("edge", "replicate"):
        return "replicate"
    if method in ("reflect", "reflect101"):
        return "reflect"
    if method in ("zero", "constant"):
        return "constant"
    raise ValueError(f"unknown pad method {method!r}")


def _pad_hw(x: torch.Tensor, top: int, bottom: int, left: int, right: int,
            method: str) -> torch.Tensor:
    lead = x.shape[:-2]
    planes = x.reshape(-1, 1, *x.shape[-2:])
    out = F.pad(planes, (left, right, top, bottom), mode=_pad_mode(method))
    return out.reshape(*lead, *out.shape[-2:])


def pad_to_divisor(x: torch.Tensor, divisor: int = 64,
                   method: str = "edge") -> torch.Tensor:
    """Pad [..., H, W] up to the next multiple of ``divisor``."""
    h, w = x.shape[-2], x.shape[-1]
    top, right, bottom, left = get_crop_pad_sequence((-h) % divisor,
                                                     (-w) % divisor)
    return _pad_hw(x, top, bottom, left, right, method)


def crop_to_target(x: torch.Tensor, target_hw: Tuple[int, int]
                   ) -> torch.Tensor:
    """Inverse of :func:`pad_to_divisor` over [..., H, W]."""
    h, w = x.shape[-2], x.shape[-1]
    top, right, bottom, left = get_crop_pad_sequence(h - target_hw[0],
                                                     w - target_hw[1])
    return x[..., top:h - bottom, left:w - right]


def pad_fixed(x: torch.Tensor, pad: Tuple[int, int], method: str = "edge"
              ) -> torch.Tensor:
    """Symmetric fixed pad of [..., H, W]: ``pad[0]`` rows top and bottom,
    ``pad[1]`` columns left and right (the training path's 102 -> 128)."""
    h_pad, w_pad = pad
    return _pad_hw(x, h_pad, h_pad, w_pad, w_pad, method)


def one_hot_target(mask: torch.Tensor) -> torch.Tensor:
    """Binary [..., H, W] mask -> fp32 [..., H, W, 2] one-hot planes
    (background, salt)."""
    fg = (mask > 0).to(torch.float32)
    return torch.stack([1.0 - fg, fg], dim=-1)


def resize_hw(x: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the trailing two axes with the semantics of
    ``jax.image.resize(method="linear")``: half-pixel centres, a triangle
    filter widened by the scale when shrinking, out-of-range taps
    dropped and the weights renormalized — torch's ``antialias=True``
    bilinear. Where no axis shrinks the filter is the plain two-tap one,
    and plain bilinear computes it with less rounding (nearer the JAX
    result: 1e-6 against 4e-6 on a 5 -> 101 upsample of values ~10)."""
    lead = x.shape[:-2]
    planes = x.reshape(-1, 1, *x.shape[-2:])
    shrinks = any(t < s for t, s in zip(target_hw, x.shape[-2:]))
    out = F.interpolate(planes, size=tuple(target_hw), mode="bilinear",
                        align_corners=False, antialias=shrinks)
    return out.reshape(*lead, *out.shape[-2:])


def normalize_gray(x01: torch.Tensor) -> torch.Tensor:
    return (x01 - IMAGENET_MEAN_GRAY) / IMAGENET_STD_GRAY


def add_depth_channels(gray_norm: torch.Tensor) -> torch.Tensor:
    """[..., H, W] normalized gray -> [..., H, W, 3] (gray, ramp,
    gray * ramp); the ramp is linspace(0, 1, H) down the rows."""
    h = gray_norm.shape[-2]
    ramp = torch.linspace(0.0, 1.0, h, dtype=gray_norm.dtype,
                          device=gray_norm.device)[:, None]
    ramp = ramp.expand(gray_norm.shape)
    return torch.stack([gray_norm, ramp, gray_norm * ramp], dim=-1)


def preprocess_inference(images_u8: torch.Tensor, pad_method: str = "edge",
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """uint8 [B, 101, 101] -> pad to a multiple of 64 (128) -> normalize
    -> depth channels -> [B, 128, 128, 3] in ``out_dtype``; the fp32
    arithmetic runs in the order the CUDA kernel repeats."""
    x = images_u8.to(torch.float32) / 255.0
    x = pad_to_divisor(x, 64, pad_method)
    return add_depth_channels(normalize_gray(x)).to(out_dtype)
