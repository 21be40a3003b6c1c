"""The reference of the first training steps, in plain float32: the batch
order, the augmentation, the input transform, the forward in training
mode, the per-image Lovász hinge, the gradients and Adam with L2.

The published training, as the served program's ``fit`` states it:

- batches: ``np.random.RandomState(seed)`` shuffles ``arange(N)`` once
  an epoch; batches of ``batch`` in that order, the ragged tail
  dropped;
- augmentation (the published imgaug policy as one composed warp): each
  step draws from a ``torch.Generator`` on the device, seeded with
  ``(seed * 1000003 + epoch * 100003 + step) mod 2**63``, in this
  order: flip gate, affine gate, angle, x-shift, perspective gate and
  scale, corner jitter, elastic gate and scale, the 5x5 displacement
  grid, sharpen and emboss gates, invert gate, contrast factor and
  gate, the intensity branch, add and multiply values, the noise plane.
  Flip, affine (+-10 degrees, x-shift +-5%), perspective (p 0.3) and
  elastic (p 0.3) compose into one coordinate map, sampled bilinearly
  with edge clamp for image and mask; then sharpen and emboss (image
  only), invert, contrast and one of {noop, add, add per pixel,
  multiply, multiply per pixel};
- input: x / 255, the augmentation, bilinear resize 101 -> 102, edge
  pad 13 -> 128, mask > 0.5, ``(x - 0.485) / 0.229`` and the depth
  channels; the target one-hot (background, salt), NHWC;
- loss: the Lovász hinge of each image's NHWC logits against the
  one-hot target, flattened (2 x 128 x 128 values), averaged over the
  batch;
- Adam (beta 0.9, 0.999, eps 1e-8) on the gradient plus ``l2`` times
  the parameter.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import serve as ref_serve

P_FLIP, P_AFFINE, P_PERSP, P_ELASTIC = 0.375, 0.375, 0.3, 0.3
P_SHARPEN, P_EMBOSS, P_INVERT, P_CONTRAST = 0.375, 0.375, 0.3, 0.3


def step_seed(seed: int, epoch: int, step: int) -> int:
    return (seed * 1_000_003 + epoch * 100_003 + step) % (1 << 63)


def batch_order(n: int, batch: int, seed: int) -> List[np.ndarray]:
    """The first epoch's batches of ``arange(n)``."""
    idx = np.arange(n)
    np.random.RandomState(seed).shuffle(idx)
    return [idx[lo:lo + batch] for lo in range(0, n - batch + 1, batch)]


def draws(g: torch.Generator, b: int, h: int, w: int) -> Dict:
    dev = g.device

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * rand(*shape)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev)

    d = {}
    d["flip"] = rand(b) < P_FLIP
    d["aff"] = rand(b) < P_AFFINE
    d["theta"] = uniform(-10.0, 10.0, b)
    d["tx"] = uniform(-0.05, 0.05, b)
    d["persp"] = rand(b) < P_PERSP
    d["pscale"] = uniform(0.05, 0.10, b)
    d["jitter"] = normal(b, 4, 2)
    d["elastic"] = rand(b) < P_ELASTIC
    d["escale"] = uniform(0.04, 0.08, b)
    d["coarse"] = normal(b, 2, 5, 5)
    d["sharpen"] = rand(b) < P_SHARPEN
    d["emboss"] = rand(b) < P_EMBOSS
    d["invert"] = rand(b) < P_INVERT
    d["alpha"] = uniform(0.5, 1.5, b)
    d["contrast"] = rand(b) < P_CONTRAST
    d["branch"] = torch.randint(0, 8, (b,), generator=g, device=dev)
    d["add"] = uniform(-10 / 255, 10 / 255, b)
    d["mul"] = uniform(0.95, 1.05, b)
    d["noise"] = uniform(-1.0, 1.0, b, h, w)
    return d


def _homography(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """[B, 3, 3] mapping the 4 points ``dst`` [4, 2] to ``src`` [B, 4, 2]."""
    b = src.shape[0]
    y, x = dst[:, 0].expand(b, 4), dst[:, 1].expand(b, 4)
    sy, sx = src[..., 0], src[..., 1]
    z, o = torch.zeros_like(sy), torch.ones_like(sy)
    a = torch.cat([torch.stack([y, x, o, z, z, z, -y * sy, -x * sy], -1),
                   torch.stack([z, z, z, y, x, o, -y * sx, -x * sx], -1)], 1)
    h = torch.linalg.solve_ex(a, torch.cat([sy, sx], 1)[..., None])[0][..., 0]
    return torch.cat([h, o[:, :1]], 1).reshape(b, 3, 3)


def warp(d: Dict, h: int, w: int):
    """The composed source coordinates (ys, xs), each [B, H, W]."""
    b = d["flip"].shape[0]
    dev = d["theta"].device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    ys, xs = ys.expand(b, h, w), xs.expand(b, h, w)

    def per(v):
        return v.reshape(b, 1, 1)

    xs = torch.where(per(d["flip"]), (w - 1) - xs, xs)
    th = torch.deg2rad(per(d["theta"]))
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    y0, x0 = ys - cy, xs - cx - per(d["tx"]) * w
    c, s = torch.cos(th), torch.sin(th)
    ys, xs = (torch.where(per(d["aff"]), c * y0 + s * x0 + cy, ys),
              torch.where(per(d["aff"]), -s * y0 + c * x0 + cx, xs))
    hw = torch.tensor([h, w], dtype=torch.float32, device=dev)
    corners = torch.tensor([[0.0, 0.0], [0.0, w - 1.0], [h - 1.0, 0.0],
                            [h - 1.0, w - 1.0]], device=dev)
    m = _homography(corners[None] + d["jitter"]
                    * d["pscale"].reshape(b, 1, 1) * hw, corners)
    m = m[:, :, :, None, None]
    den = m[:, 2, 0] * ys + m[:, 2, 1] * xs + m[:, 2, 2]
    yp = (m[:, 0, 0] * ys + m[:, 0, 1] * xs + m[:, 0, 2]) / den
    xp = (m[:, 1, 0] * ys + m[:, 1, 1] * xs + m[:, 1, 2]) / den
    ys = torch.where(per(d["persp"]), yp, ys)
    xs = torch.where(per(d["persp"]), xp, xs)
    coarse = (d["coarse"] * d["escale"].reshape(b, 1, 1, 1)
              * hw.reshape(1, 2, 1, 1) * 0.5)
    field = F.interpolate(coarse, size=(h, w), mode="bilinear",
                          align_corners=False)
    ys = torch.where(per(d["elastic"]), ys + field[:, 0], ys)
    xs = torch.where(per(d["elastic"]), xs + field[:, 1], xs)
    return ys, xs


def sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """Bilinear sampling of [B, H, W] at (ys, xs), edges clamped."""
    b, h, w = img.shape
    ys, xs = ys.clamp(0.0, h - 1.0), xs.clamp(0.0, w - 1.0)
    y0, x0 = ys.floor(), xs.floor()
    wy, wx = ys - y0, xs - x0
    y0, x0 = y0.long(), x0.long()
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    flat = img.reshape(b, h * w)

    def at(yi, xi):
        return flat.gather(1, (yi * w + xi).reshape(b, -1)).reshape(b, h, w)

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


SHARPEN = ((-1.0, -1.0, -1.0), (-1.0, 17.0, -1.0), (-1.0, -1.0, -1.0))
EMBOSS = ((-1.0, -1.0, 0.0), (-1.0, 1.0, 1.0), (0.0, 1.0, 1.0))


def _filter(img, kernel, scale=1.0):
    """SAME 3x3 cross-correlation, zero padded, of each [H, W] plane."""
    k = torch.tensor(kernel, dtype=img.dtype, device=img.device) / scale
    return F.conv2d(img[:, None], k[None, None], padding=1)[:, 0]


def image_ops(d: Dict, img: torch.Tensor) -> torch.Tensor:
    b = img.shape[0]

    def per(v):
        return v.reshape(b, 1, 1)

    img = torch.where(per(d["sharpen"]),
                      0.5 * img + 0.5 * _filter(img, SHARPEN, 9.0), img)
    emb = 0.5 * img + 0.5 * torch.clamp(_filter(img, EMBOSS) + 0.5, 0, 1)
    img = torch.where(per(d["emboss"]), emb, img)
    img = img.clamp(0.0, 1.0)
    img = torch.where(per(d["invert"]), 1.0 - img, img)
    img = torch.where(per(d["contrast"]),
                      ((img - 0.5) * per(d["alpha"]) + 0.5).clamp(0, 1), img)
    br, noise = per(d["branch"]), d["noise"]
    img = torch.where(br == 4, img + per(d["add"]), img)
    img = torch.where(br == 5, img + noise * (10 / 255), img)
    img = torch.where(br == 6, img * per(d["mul"]), img)
    img = torch.where(br == 7, img * (1.0 + noise * 0.05), img)
    return img.clamp(0.0, 1.0)


def train_inputs(images_u8: torch.Tensor, masks_u8: torch.Tensor,
                 g: torch.Generator):
    """uint8 [B, 101, 101] images and masks -> the fp32 network input
    [B, 3, 128, 128] and the one-hot NHWC target [B, 128, 128, 2]."""
    b, h, w = images_u8.shape
    d = draws(g, b, h, w)
    x = images_u8.float() / 255.0
    m = (masks_u8 > 0).float()
    ys, xs = warp(d, h, w)
    x = image_ops(d, sample(x, ys, xs))
    m = sample(m, ys, xs)

    def resize_pad(t):
        t = F.interpolate(t[:, None], size=(102, 102), mode="bilinear",
                          align_corners=False)
        return F.pad(t, (13, 13, 13, 13), mode="replicate")[:, 0]

    x, m = resize_pad(x), (resize_pad(m) > 0.5).float()
    g_ = (x - ref_serve.MEAN) / ref_serve.STD
    ramp = torch.linspace(0.0, 1.0, g_.shape[-2], device=g_.device)[:, None]
    x = torch.stack([g_, ramp.expand_as(g_), g_ * ramp], dim=1)
    return x, torch.stack([1.0 - m, m], dim=-1)


def lovasz_hinge(logits_nhwc: torch.Tensor, target: torch.Tensor
                 ) -> torch.Tensor:
    """The per-image Lovász hinge, averaged over the batch."""
    b = logits_nhwc.shape[0]
    logits = logits_nhwc.reshape(b, -1)
    labels = target.reshape(b, -1)
    errors = 1.0 - logits * (2.0 * labels - 1.0)
    errors_sorted, perm = torch.sort(errors, dim=-1, descending=True,
                                     stable=True)
    gt = labels.gather(-1, perm)
    total = gt.sum(-1, keepdim=True)
    inter = total - gt.cumsum(-1)
    union = total + (1.0 - gt).cumsum(-1)
    jac = 1.0 - inter / union
    grad = torch.cat([jac[:, :1], jac[:, 1:] - jac[:, :-1]], -1)
    return (F.elu(errors_sorted) * grad).sum(-1).mean()


class Adam:
    """Adam with L2 added to the gradient, over named parameters."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 l2: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.l2 = params, lr, l2
        self.b1, self.b2 = betas
        self.eps = eps
        self.t = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """One update; returns each gradient as Adam took it."""
        self.t += 1
        taken = {}
        for k, p in self.params.items():
            g = p.grad + self.l2 * p
            taken[k] = g
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            mh = self.m[k] / (1 - self.b1 ** self.t)
            vh = self.v[k] / (1 - self.b2 ** self.t)
            p.sub_(self.lr * mh / (vh.sqrt() + self.eps))
            p.grad = None
        return taken


def first_steps(model: torch.nn.Module, images_u8: torch.Tensor,
                masks_u8: torch.Tensor, batches: List[np.ndarray],
                seed: int, lr: float, l2: float, conv=None,
                loss_fn=None) -> Dict:
    """Run ``batches`` (the first steps of epoch 0) from ``model``'s
    state in training mode: each step's loss, the first step's logits and
    its gradient as Adam took it, and each parameter after the last
    step."""
    model.train()
    params = dict(model.named_parameters())
    opt = Adam(params, lr, l2)
    losses, first, first_logits = [], None, None
    g = torch.Generator(images_u8.device)
    for step, idx in enumerate(batches):
        g.manual_seed(step_seed(seed, 0, step))
        sel = torch.from_numpy(idx).to(images_u8.device)
        x, y = train_inputs(images_u8[sel], masks_u8[sel], g)
        logits = model(x, conv)
        if first_logits is None:
            first_logits = logits.detach().clone()
        loss = (loss_fn or lovasz_hinge)(logits.permute(0, 2, 3, 1), y)
        loss.backward()
        losses.append(float(loss.detach()))
        taken = opt.step()
        if first is None:
            first = {k: v.detach().clone() for k, v in taken.items()}
    return {"losses": losses, "first_grad": first,
            "first_logits": first_logits,
            "params": {k: p.detach().clone() for k, p in params.items()}}


def norm_gaps(program: Dict[str, torch.Tensor],
              reference: Dict[str, torch.Tensor]) -> np.ndarray:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of the reference leaf's norm and the median leaf's."""
    ref = {k: float(v.double().norm()) for k, v in reference.items()}
    median = float(np.median(list(ref.values())))
    return np.array([abs(float(program[k].double().norm()) - r)
                     / max(r, median, 1e-30) for k, r in ref.items()])
