"""Stochastic training augmentation on the device (counterpart of
``salt_tpu/ops/augment.py`` :43-295).

The same policy as the JAX package: flip + affine (rotate +-10 deg,
translate x +-5%) + perspective (jittered corners, p=0.3) + elastic
(coarse 5x5 displacement grid, p=0.3) composed into ONE coordinate map
and ONE bilinear gather per batch, shared by image and mask; then
sharpen / emboss (image only) and the intensity policy (invert,
contrast, one of {noop, add, add-elementwise, multiply,
multiply-elementwise}).

Drawing is split from applying. :func:`draw_augment_params` takes every
per-image random value from a ``torch.Generator`` (on the runner's
device); :func:`apply_augment` is deterministic given them, so the tests
feed it the values JAX draws from a key and hold it against
``augment_batch`` exactly. The port's draws are not JAX's bits; their
distribution is the same.

Images are float [B, H, W] in [0, 1]; masks get the geometry only.
``bilinear_sample`` is the 4-tap gather form; the JAX package's one-hot
matmul form worked around XLA:TPU's serial gathers and is not needed on
the card.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Tuple

import torch
import torch.nn.functional as F

from salt_tpu_torch.ops.preprocess import resize_hw

P_FLIP = 0.375
P_AFFINE = 0.375
P_PERSPECTIVE = 0.3
P_PIECEWISE = 0.3
P_SHARPEN = 0.375
P_EMBOSS = 0.375
P_INVERT = 0.3
P_CONTRAST = 0.3
ROTATE_DEG = 10.0
TRANSLATE_FRAC = 0.05
PERSP_SCALE = (0.05, 0.10)
ELASTIC_SCALE = (0.04, 0.08)
ELASTIC_GRID = 5
N_BRANCHES = 8          # branches 0-3 are the noop (p = 1/2), then 4..7

_SHARPEN_K = ((-1.0, -1.0, -1.0), (-1.0, 17.0, -1.0), (-1.0, -1.0, -1.0))
_EMBOSS_K = ((-1.0, -1.0, 0.0), (-1.0, 1.0, 1.0), (0.0, 1.0, 1.0))


@dataclass
class AugmentParams:
    """Every per-image random value of one batch, as drawn (before any
    scaling): gates are bool [B]; ``theta`` degrees, ``tx`` a fraction of
    the width, ``jitter`` [B, 4, 2] and ``coarse`` [B, 2, 5, 5] standard
    normals, ``noise`` [B, H, W] uniform in [-1, 1)."""
    do_flip: torch.Tensor
    do_aff: torch.Tensor
    theta: torch.Tensor
    tx: torch.Tensor
    do_persp: torch.Tensor
    scale: torch.Tensor
    jitter: torch.Tensor
    do_pw: torch.Tensor
    e_scale: torch.Tensor
    coarse: torch.Tensor
    gate_s: torch.Tensor
    gate_e: torch.Tensor
    inv_gate: torch.Tensor
    alpha: torch.Tensor
    cn_gate: torch.Tensor
    branch: torch.Tensor
    add_v: torch.Tensor
    mul_v: torch.Tensor
    noise: torch.Tensor

    def to(self, device) -> "AugmentParams":
        return AugmentParams(**{f.name: getattr(self, f.name).to(device)
                                for f in fields(self)})


def draw_augment_params(generator: torch.Generator, b: int, h: int,
                        w: int) -> AugmentParams:
    """Draw one batch's augmentation from ``generator``, on its device."""
    dev = generator.device

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * rand(*shape)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    return AugmentParams(
        do_flip=rand(b) < P_FLIP,
        do_aff=rand(b) < P_AFFINE,
        theta=uniform(-ROTATE_DEG, ROTATE_DEG, b),
        tx=uniform(-TRANSLATE_FRAC, TRANSLATE_FRAC, b),
        do_persp=rand(b) < P_PERSPECTIVE,
        scale=uniform(*PERSP_SCALE, b),
        jitter=normal(b, 4, 2),
        do_pw=rand(b) < P_PIECEWISE,
        e_scale=uniform(*ELASTIC_SCALE, b),
        coarse=normal(b, 2, ELASTIC_GRID, ELASTIC_GRID),
        gate_s=rand(b) < P_SHARPEN,
        gate_e=rand(b) < P_EMBOSS,
        inv_gate=rand(b) < P_INVERT,
        alpha=uniform(0.5, 1.5, b),
        cn_gate=rand(b) < P_CONTRAST,
        branch=torch.randint(0, N_BRANCHES, (b,), generator=generator,
                             device=dev),
        add_v=uniform(-10 / 255, 10 / 255, b),
        mul_v=uniform(0.95, 1.05, b),
        noise=uniform(-1.0, 1.0, b, h, w),
    )


# ---------------------------------------------------------------------------
# batched bilinear sampling
# ---------------------------------------------------------------------------

def bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
                    ) -> torch.Tensor:
    """Sample [B, H, W] images at float coordinates [B, H, W] with edge
    clamp: four gathers and the bilinear blend, in the JAX package's
    order of operations."""
    b, h, w = img.shape
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    y0 = y0.to(torch.int64)
    x0 = x0.to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    flat = img.reshape(b, h * w)

    def gather(yi, xi):
        return flat.gather(1, (yi * w + xi).reshape(b, h * w)).reshape(b, h, w)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy


# ---------------------------------------------------------------------------
# geometry: one composed [B, H, W] coordinate map
# ---------------------------------------------------------------------------

def _homography(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Batched 4-point homography: fixed corners ``dst`` [4, 2] -> ``src``
    [B, 4, 2]; returns [B, 3, 3] mapping dst coordinates to src ones."""
    b = src.shape[0]
    y, x = dst[:, 0], dst[:, 1]
    sy, sx = src[..., 0], src[..., 1]
    zeros = torch.zeros((b, 4), dtype=src.dtype, device=src.device)
    ones = torch.ones((b, 4), dtype=src.dtype, device=src.device)
    yb = y.expand(b, 4)
    xb = x.expand(b, 4)
    row1 = torch.stack([yb, xb, ones, zeros, zeros, zeros,
                        -yb * sy, -xb * sy], dim=-1)
    row2 = torch.stack([zeros, zeros, zeros, yb, xb, ones,
                        -yb * sx, -xb * sx], dim=-1)
    a = torch.cat([row1, row2], dim=1)                  # [B, 8, 8]
    rhs = torch.cat([sy, sx], dim=1)                    # [B, 8]
    # solve_ex: no host-side error check, so no device sync per step
    hvec = torch.linalg.solve_ex(a, rhs[..., None])[0][..., 0]
    return torch.cat([hvec, ones[:, :1]], dim=1).reshape(b, 3, 3)


def make_warp_coords(params: AugmentParams, h: int, w: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compose flip, affine, perspective and elastic into source
    coordinates (ys, xs), each [B, H, W]."""
    b = params.do_flip.shape[0]
    dev = params.theta.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    ys = ys.expand(b, h, w)
    xs = xs.expand(b, h, w)

    def per_image(v):
        return v.reshape(b, 1, 1)

    xs = torch.where(per_image(params.do_flip), (w - 1) - xs, xs)

    # affine: rotation about the centre + x-translation
    theta = torch.deg2rad(per_image(params.theta))
    tx = per_image(params.tx) * w
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    y0 = ys - cy
    x0 = xs - cx - tx
    do_aff = per_image(params.do_aff)
    ys, xs = (torch.where(do_aff, cos * y0 + sin * x0 + cy, ys),
              torch.where(do_aff, -sin * y0 + cos * x0 + cx, xs))

    # perspective: jittered-corner homography
    hw = torch.tensor([h, w], dtype=torch.float32, device=dev)
    jitter = params.jitter * params.scale.reshape(b, 1, 1) * hw
    dst = torch.tensor([[0.0, 0.0], [0.0, w - 1.0], [h - 1.0, 0.0],
                        [h - 1.0, w - 1.0]], device=dev)
    hm = _homography(dst, dst[None] + jitter)
    hm = hm[:, :, :, None, None]                        # [B, 3, 3, 1, 1]
    denom = hm[:, 2, 0] * ys + hm[:, 2, 1] * xs + hm[:, 2, 2]
    ys_p = (hm[:, 0, 0] * ys + hm[:, 0, 1] * xs + hm[:, 0, 2]) / denom
    xs_p = (hm[:, 1, 0] * ys + hm[:, 1, 1] * xs + hm[:, 1, 2]) / denom
    do_persp = per_image(params.do_persp)
    ys = torch.where(do_persp, ys_p, ys)
    xs = torch.where(do_persp, xs_p, xs)

    # elastic: coarse displacement grid, bilinearly upsampled
    coarse = (params.coarse * params.e_scale.reshape(b, 1, 1, 1)
              * hw.reshape(1, 2, 1, 1) * 0.5)
    field = resize_hw(coarse, (h, w))
    do_pw = per_image(params.do_pw)
    ys = torch.where(do_pw, ys + field[:, 0], ys)
    xs = torch.where(do_pw, xs + field[:, 1], xs)
    return ys, xs


# ---------------------------------------------------------------------------
# image-only filters and intensity policy
# ---------------------------------------------------------------------------

def _conv3(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 cross-correlation with zero padding, per image."""
    return F.conv2d(img[:, None], kernel[None, None], padding=1)[:, 0]


def filter_ops(params: AugmentParams, img: torch.Tensor) -> torch.Tensor:
    """Sharpen (alpha 0.5) and emboss (alpha 0.5, strength 1), each gated
    per image."""
    b = img.shape[0]
    sharpen = torch.tensor(_SHARPEN_K, dtype=img.dtype, device=img.device) / 9.0
    emboss = torch.tensor(_EMBOSS_K, dtype=img.dtype, device=img.device)
    sharp = 0.5 * img + 0.5 * _conv3(img, sharpen)
    img = torch.where(params.gate_s.reshape(b, 1, 1), sharp, img)
    emb = 0.5 * img + 0.5 * torch.clamp(_conv3(img, emboss) + 0.5, 0, 1)
    img = torch.where(params.gate_e.reshape(b, 1, 1), emb, img)
    return torch.clamp(img, 0.0, 1.0)


def intensity_ops(params: AugmentParams, img: torch.Tensor) -> torch.Tensor:
    b = img.shape[0]

    def per_image(v):
        return v.reshape(b, 1, 1)

    img = torch.where(per_image(params.inv_gate), 1.0 - img, img)
    contrasted = torch.clamp((img - 0.5) * per_image(params.alpha) + 0.5,
                             0.0, 1.0)
    img = torch.where(per_image(params.cn_gate), contrasted, img)
    branch = per_image(params.branch)
    noise = params.noise
    img = torch.where(branch == 4, img + per_image(params.add_v), img)
    img = torch.where(branch == 5, img + noise * (10 / 255), img)
    img = torch.where(branch == 6, img * per_image(params.mul_v), img)
    img = torch.where(branch == 7, img * (1.0 + noise * 0.05), img)
    return torch.clamp(img, 0.0, 1.0)


# ---------------------------------------------------------------------------
# batch API
# ---------------------------------------------------------------------------

def apply_augment(params: AugmentParams, images: torch.Tensor,
                  masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full training policy over [B, H, W] float images and masks with
    the given draws: one warp shared by both, then the image-only ops."""
    h, w = images.shape[-2:]
    ys, xs = make_warp_coords(params, h, w)
    out_i = bilinear_sample(images, ys, xs)
    out_m = bilinear_sample(masks, ys, xs)
    return intensity_ops(params, filter_ops(params, out_i)), out_m


def augment_batch(generator: torch.Generator, images: torch.Tensor,
                  masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw from ``generator`` and apply (``augment_batch`` of the JAX
    package, with a generator in place of the key)."""
    b, h, w = images.shape
    return apply_augment(draw_augment_params(generator, b, h, w), images,
                         masks)
