"""The inference half of ``SegmentationRunner`` (counterpart of
``salt_tpu/train/steps.py``: ``_infer_inputs`` :150-169, ``predict_step``
:229-243, ``predict_tta_step`` :279-309, ``predict_dataset`` :337-381).

Where the JAX package compiles one graph per step, the port runs the
same steps eagerly on ``device``: uint8 images in, preprocess (the CUDA
kernel for the production geometry on the card), forward, fp32 sigmoid,
TTA inverse + aggregate in 128x128 network space, then crop (or resize)
back to 101x101. ``lax.scan`` over batches becomes a Python loop over
batches on the device.

Models are ``nn.Module``s in eval mode, cast to ``training.dtype`` (the
fp32 head aside), in channels_last memory, placed on ``device`` once by
:meth:`SegmentationRunner.init_model` / :meth:`restore`.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch
from torch import nn

from salt_tpu_torch.core.config import Config
from salt_tpu_torch.core.device import resolve_device
from salt_tpu_torch.core.experiment import load_flat_npz
from salt_tpu_torch.models.convert import load_flax_flat
from salt_tpu_torch.models.registry import DTYPES, build_model, init_seeded
from salt_tpu_torch.ops.preprocess import (add_depth_channels, crop_to_target,
                                           normalize_gray, pad_to_divisor,
                                           resize_hw)
from salt_tpu_torch.ops.preprocess_kernel import preprocess_inference_kernel
from salt_tpu_torch.ops.tta import (aggregate, build_tta_specs,
                                    tta_inverse_transform, tta_transform)


class SegmentationRunner:
    def __init__(self, config: Config,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.dtype = DTYPES[config.training.dtype]
        ex = config.execution
        # as in the JAX runner: resize_and_pad pads, every other mode resizes
        self._pp = dict(pad_method=ex.pad_method, loader_mode=ex.loader_mode)
        self._img_hw = (config.image.raw_h, config.image.raw_w)
        self._net_hw = (config.image.h, config.image.w)
        # the fused kernel's geometry (the rule of the JAX package's
        # _use_pallas_preprocess); other geometries take the plain ops
        self._use_preprocess_kernel = (
            ex.loader_mode == "resize_and_pad"
            and ex.pad_method in ("edge", "replicate")
            and self._img_hw == (101, 101) and self._net_hw == (128, 128))

    # -- models -----------------------------------------------------------
    def place(self, model: nn.Module) -> nn.Module:
        model.set_compute_dtype(self.dtype)
        return model.to(self.device, memory_format=torch.channels_last).eval()

    def init_model(self, seed: int = 1234) -> nn.Module:
        """A seeded model on the device (``models.registry.init_seeded``)."""
        return self.place(init_seeded(build_model(self.config.model), seed))

    def restore(self, checkpoint: str) -> nn.Module:
        """A flat-npz checkpoint (either package's ``best.npz``), moved to
        the device once."""
        model = build_model(self.config.model)
        load_flax_flat(model, load_flat_npz(checkpoint))
        return self.place(model)

    # -- fused steps ----------------------------------------------------------
    def _infer_inputs(self, images_u8: torch.Tensor) -> torch.Tensor:
        """uint8 [B, h, w] -> [B, 3, 128, 128] network input in the
        compute dtype, channels_last."""
        if self._use_preprocess_kernel and images_u8.dtype == torch.uint8:
            x = preprocess_inference_kernel(images_u8.contiguous(),
                                            out_dtype=self.dtype)
        else:
            x = images_u8.to(torch.float32) / 255.0
            if self._pp["loader_mode"] == "resize_and_pad":
                x = pad_to_divisor(x, 64, self._pp["pad_method"])
            else:
                x = resize_hw(x, self._net_hw)
            x = add_depth_channels(normalize_gray(x)).to(self.dtype)
        return x.permute(0, 3, 1, 2)          # NHWC bytes = channels_last

    def _to_image_space(self, probs: torch.Tensor) -> torch.Tensor:
        if self._pp["loader_mode"] == "resize_and_pad":
            return crop_to_target(probs, self._img_hw)
        return resize_hw(probs, self._img_hw)

    @torch.no_grad()
    def predict_step(self, model: nn.Module,
                     images_u8: torch.Tensor) -> torch.Tensor:
        """uint8 [B, 101, 101] -> fp32 probabilities [B, 2, 101, 101]."""
        logits = model(self._infer_inputs(images_u8))
        return self._to_image_space(torch.sigmoid(logits.float()))

    @torch.no_grad()
    def predict_tta_step(self, model: nn.Module,
                         images_u8: torch.Tensor) -> torch.Tensor:
        """All TTA specs of the batch in ONE forward pass of [T*B]: the
        uint8 101x101 images are transformed BEFORE the pad (the pad is
        asymmetric), the 128x128 probabilities inverse-transformed and
        aggregated before the crop."""
        pp = self.config.postpro
        specs = build_tta_specs(pp.tta_flip_ud, pp.tta_flip_lr,
                                pp.tta_rotation, pp.tta_color_shift_runs)
        b = images_u8.shape[0]
        big = torch.cat([tta_transform(images_u8, s) for s in specs], dim=0)
        logits = model(self._infer_inputs(big))
        probs = torch.sigmoid(logits.float())                 # [T*B,2,H,W]
        outs = [tta_inverse_transform(probs[i * b:(i + 1) * b], s)
                for i, s in enumerate(specs)]
        agg = aggregate(torch.stack(outs), pp.tta_aggregation_method)
        return self._to_image_space(agg)

    def predict_dataset(self, model: nn.Module, images: np.ndarray,
                        batch_size: int = 0, tta: bool = False,
                        chunk: int = 2048) -> np.ndarray:
        """uint8 [N, 101, 101] -> fp32 [N, 2, 101, 101]. Ragged chunks are
        padded with zero images to a batch multiple and the padding is
        dropped afterwards."""
        step = self.predict_tta_step if tta else self.predict_step
        bs = batch_size or self.config.training.batch_size_inference
        n = images.shape[0]
        if n == 0:
            return np.zeros((0, 2, *self._img_hw), np.float32)
        chunk = max(bs, (chunk // bs) * bs)
        outs = []
        for lo in range(0, n, chunk):
            count = min(chunk, n - lo)
            batch = pad_batch(images[lo:lo + count], bs)
            imgs = torch.from_numpy(batch).to(self.device)
            probs = torch.cat([step(model, imgs[i:i + bs])
                               for i in range(0, imgs.shape[0], bs)])
            outs.append(probs[:count].cpu().numpy())
        return np.concatenate(outs, axis=0)


def pad_batch(images: np.ndarray, batch_size: int) -> np.ndarray:
    """Append zero images up to a multiple of ``batch_size``."""
    pad = (-images.shape[0]) % batch_size
    if pad:
        images = np.concatenate(
            [images, np.zeros((pad, *images.shape[1:]), images.dtype)])
    return np.ascontiguousarray(images)
