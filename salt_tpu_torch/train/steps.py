"""``SegmentationRunner``: the train, eval and predict steps of one
network (counterpart of ``salt_tpu/train/steps.py``: ``_train_inputs``
:125-148, ``_infer_inputs`` :150-169, ``train_step`` :198-223,
``predict_step`` :229-243, ``val_loss_step`` :245-257, ``metrics_step``
:259-277, ``predict_tta_step`` :279-309, ``predict_dataset`` :337-381).

Where the JAX package compiles one graph per step, the port runs the
same steps eagerly on ``device``.

- Inference: uint8 images in, preprocess (the CUDA kernel for the
  production geometry on the card), forward, fp32 sigmoid, TTA inverse +
  aggregate in 128x128 network space, then crop (or resize) back to
  101x101. ``lax.scan`` over batches becomes a Python loop.
- Training: augmentation drawn from a ``torch.Generator`` on the device
  and applied, resize 102, pad 13, normalize + depth channels (plain ops
  on every device: the JAX package has no kernel there), forward, the
  per-image Lovász hinge over NHWC logits (the sort kernel on the card),
  backward, Adam. ``_train_inputs`` and :meth:`update` are the two halves
  of :meth:`train_step`, so each can be held against JAX on its own.

Two forms of one model, as in the JAX runner (:55-67): the predict steps
run the infer form (``model(x, infer=True)``: the config's
``decoder_impl`` / ``hypercolumn_impl`` and ``model.pallas_conv``'s conv
dispatch), training and :meth:`val_loss_step` the train form (literal
concats, plain convs). Both read the one set of parameters on the device.

Depth: ``use_depth`` is ``execution.use_depth`` or an architecture that
takes the depth (``registry.takes_depth``), as in the JAX runner
(:53-54). Every step then takes the images' depths [B, 1] (z / 1000)
and hands them to the model, zeros where the caller has none, as the
JAX package's loop, validation and serve feed them; the TTA step repeats
them once per spec. ``use_depth`` with a model that takes no depth
raises ``TypeError`` where a model is made, as JAX's ``init_state``
does.

Serving models are ``nn.Module``s in eval mode, cast to
``training.dtype`` (the fp32 head aside), in channels_last memory on the
card (NCHW on the CPU, whose channels-last kernels lose fp32 accuracy on
one thread), placed on ``device`` once by :meth:`init_model` /
:meth:`restore`. A model being trained keeps fp32 parameters and
computes in ``training.dtype`` under autocast (:meth:`train_state`).
"""
from __future__ import annotations

from functools import cached_property
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from salt_tpu_torch.core.config import Config
from salt_tpu_torch.core.device import resolve_device
from salt_tpu_torch.core.experiment import load_flat_npz
from salt_tpu_torch.core.logging import get_logger
from salt_tpu_torch.data.pipeline import to_device
from salt_tpu_torch.losses.api import get_loss_fn
from salt_tpu_torch.models.convert import load_flax_flat
from salt_tpu_torch.models.registry import (DTYPES, build_model,
                                            init_flax_like, init_seeded,
                                            takes_depth)
from salt_tpu_torch.ops.augment import (AugmentParams, apply_augment,
                                        draw_augment_params)
from salt_tpu_torch.ops.preprocess import (add_depth_channels, crop_to_target,
                                           normalize_gray, one_hot_target,
                                           pad_fixed, pad_to_divisor,
                                           resize_hw)
from salt_tpu_torch.ops.preprocess_kernel import preprocess_inference_kernel
from salt_tpu_torch.ops.tta import (aggregate, build_tta_specs,
                                    tta_inverse_transform, tta_transform)
from salt_tpu_torch.train.state import TrainState, make_optimizer

#: validation threshold sweep grid (reference: callbacks.py:503)
SWEEP_THRESHOLDS = np.linspace(0.5, 0.3, 21)
#: the IOUT thresholds 0.50:0.05:0.95 as ``metrics_step`` builds them
_IOUT_GRID = np.arange(0.5, 1.0, 0.05)


class SegmentationRunner:
    def __init__(self, config: Config,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.dtype = DTYPES[config.training.dtype]
        ex = config.execution
        self.use_depth = (ex.use_depth
                          or takes_depth(config.model.architecture))
        self._memory_format = (torch.channels_last
                               if self.device.type == "cuda"
                               else torch.contiguous_format)
        # as in the JAX runner: resize_and_pad pads, every other mode resizes
        self._pp = dict(pad_method=ex.pad_method, loader_mode=ex.loader_mode,
                        resize_size=ex.resize_target_size,
                        pad_size=ex.pad_size)
        self._img_hw = (config.image.raw_h, config.image.raw_w)
        self._net_hw = (config.image.h, config.image.w)
        # the fused kernel's geometry (the rule of the JAX package's
        # _use_pallas_preprocess); other geometries take the plain ops
        self._use_preprocess_kernel = (
            ex.loader_mode == "resize_and_pad"
            and ex.pad_method in ("edge", "replicate")
            and self._img_hw == (101, 101) and self._net_hw == (128, 128))

    # -- models -----------------------------------------------------------
    def build(self) -> nn.Module:
        """The configured architecture, fp32, in eval mode."""
        model = build_model(self.config.model)
        if self.use_depth and not model.takes_depth:
            raise TypeError(
                f"execution.use_depth=true: {self.config.model.architecture}"
                " takes no depth input (a depth model is "
                "UNetResNetWithDepth)")
        return model

    def place(self, model: nn.Module) -> nn.Module:
        model.set_compute_dtype(self.dtype)
        return model.to(self.device, memory_format=self._memory_format).eval()

    def init_model(self, seed: int = 1234) -> nn.Module:
        """A seeded model on the device (``models.registry.init_seeded``)."""
        return self.place(init_seeded(self.build(), seed))

    def restore(self, checkpoint: Union[str, Dict[str, np.ndarray]]
                ) -> nn.Module:
        """A flat-npz checkpoint (either package's ``best.npz``, or its
        arrays), moved to the device once."""
        if isinstance(checkpoint, str):
            checkpoint = load_flat_npz(checkpoint)
        model = self.build()
        load_flax_flat(model, checkpoint)
        return self.place(model)

    @cached_property
    def loss_fn(self):
        """``training.loss``, resolved at the first train or validation
        step (serving needs no loss)."""
        return get_loss_fn(self.config.training.loss)

    def train_state(self, model: nn.Module) -> TrainState:
        """``model`` on the device for training: fp32 parameters
        (channels_last on the card) computing in ``training.dtype``, with the
        JAX package's Adam over them."""
        model = model.to(self.device, memory_format=self._memory_format)
        model.set_training_precision(self.dtype)
        t = self.config.training
        return TrainState(model, make_optimizer(model, t.lr, t.l2_reg_conv))

    def init_state(self, seed: int = 1234) -> TrainState:
        """A fresh train state from flax's default initializers, seeded;
        with ``model.pretrained`` the encoder is then grafted from
        ``model.pretrained_weights_path`` (the JAX runner's
        ``_graft_pretrained``, :94-122)."""
        model = init_flax_like(self.build(), seed)
        if self.config.model.pretrained:
            self._graft_pretrained(model)
        return self.train_state(model)

    def _graft_pretrained(self, model: nn.Module) -> None:
        from salt_tpu_torch.models.torch_import import (convert_encoder,
                                                        graft_encoder,
                                                        load_state_dict)
        path = self.config.model.pretrained_weights_path
        if not path:
            raise ValueError(
                "model.pretrained=True requires model.pretrained_weights_path"
                " — a torch .pth/.pt or converted .npz encoder checkpoint "
                "(nothing is downloaded)")
        n = graft_encoder(model, *convert_encoder(load_state_dict(path)))
        get_logger().info("grafted pretrained encoder from %s (%d arrays)",
                          path, n)

    def depth_input(self, depths: Optional[torch.Tensor],
                    b: int) -> Optional[torch.Tensor]:
        """The model's depth argument: None without ``use_depth``, else
        ``depths`` as [B, 1] fp32 on the device (zeros when None)."""
        if not self.use_depth:
            return None
        if depths is None:
            return torch.zeros((b, 1), dtype=torch.float32,
                               device=self.device)
        return depths.reshape(b, 1).to(self.device, torch.float32)

    def device_batch(self, *arrays: np.ndarray):
        """Host arrays -> device tensors (pinned, asynchronous on CUDA)."""
        return tuple(to_device(a, self.device) for a in arrays)

    # -- training ---------------------------------------------------------------
    def _train_inputs(self, images_u8: torch.Tensor, masks_u8: torch.Tensor,
                      params: AugmentParams):
        """Augment with ``params``, then resize 102 -> pad 13 -> 128 (or
        resize to the network size in ``resize`` mode) -> normalize +
        depth channels. Returns the fp32 network input [B, 3, H, W]
        (channels_last) and the one-hot target [B, H, W, 2] (NHWC)."""
        x = images_u8.to(torch.float32) / 255.0
        m = (masks_u8 > 0).to(torch.float32)
        x, m = apply_augment(params, x, m)
        if self._pp["loader_mode"] != "resize":
            size = (self._pp["resize_size"],) * 2
            pad = (self._pp["pad_size"],) * 2
            x = pad_fixed(resize_hw(x, size), pad, self._pp["pad_method"])
            m = pad_fixed(resize_hw(m, size), pad, self._pp["pad_method"])
        else:
            x = resize_hw(x, self._net_hw)
            m = resize_hw(m, self._net_hw)
        m = (m > 0.5).to(torch.float32)
        x = add_depth_channels(normalize_gray(x))
        return x.permute(0, 3, 1, 2), one_hot_target(m)

    def train_loss(self, logits: torch.Tensor, y) -> torch.Tensor:
        """The training loss of NCHW ``logits`` against the NHWC target."""
        return self.loss_fn(logits.permute(0, 2, 3, 1), y)

    def update(self, state: TrainState, x: torch.Tensor, y: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               depths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Forward in train mode, :meth:`train_loss`, backward, one Adam
        step; BatchNorm statistics move in the forward. Returns the
        loss (a 0-d tensor on the device)."""
        model = state.model
        model.train()
        logits = model(x, generator,
                       depth=self.depth_input(depths, x.shape[0]))
        loss = self.train_loss(logits, y)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    def train_step(self, state: TrainState, images_u8: torch.Tensor,
                   masks_u8: torch.Tensor, generator: torch.Generator,
                   depths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One training step on uint8 [B, 101, 101] images and masks (and
        their depths); the augmentation (and any dropout) draws from
        ``generator``."""
        b, h, w = images_u8.shape
        params = draw_augment_params(generator, b, h, w)
        x, y = self._train_inputs(images_u8, masks_u8, params)
        return self.update(state, x, y, generator, depths)

    @torch.no_grad()
    def val_loss_step(self, model: nn.Module, images_u8: torch.Tensor,
                      masks_u8: torch.Tensor,
                      depths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Validation loss in network space on inference-preprocessed
        batches (the preprocess kernel on the card); ``model`` in eval
        mode, in the train form as in the JAX runner."""
        x = self._infer_inputs(images_u8)
        m = (masks_u8 > 0).to(torch.float32)
        if self._pp["loader_mode"] == "resize_and_pad":
            m = pad_to_divisor(m, 64, self._pp["pad_method"])
        else:
            m = resize_hw(m, self._net_hw)
        y = one_hot_target((m > 0.5).to(torch.float32))
        logits = model(x, depth=self.depth_input(depths, x.shape[0]))
        return self.loss_fn(logits.permute(0, 2, 3, 1), y)

    @staticmethod
    def metrics_step(probs_salt: torch.Tensor, gt: torch.Tensor,
                     thresholds: torch.Tensor):
        """Per-image IoU and IOUT at every sweep threshold in one pass:
        ``probs_salt`` / ``gt`` [B, 101, 101], ``thresholds`` [T]; returns
        (iou [T, B], iout [T, B])."""
        gtb = gt > 0
        pred = probs_salt[None] > thresholds[:, None, None, None]
        inter = (pred & gtb[None]).sum(dim=(2, 3)).to(torch.float32)
        union = (pred | gtb[None]).sum(dim=(2, 3)).to(torch.float32)
        gt_any = gtb.flatten(1).any(dim=1)[None]
        pred_any = pred.flatten(2).any(dim=2)
        both_empty = ~gt_any & ~pred_any
        iou_val = torch.where(union > 0,
                              inter / torch.clamp(union, min=1.0), 0.0)
        iou = torch.where(both_empty, 1.0, iou_val)
        grid = torch.tensor(_IOUT_GRID, dtype=torch.float32,
                            device=probs_salt.device)
        hits = (iou_val[..., None] >= grid).to(torch.float32)
        iout = torch.where(both_empty, 1.0, hits.mean(dim=-1))
        return iou, iout

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
    def predict_step(self, model: nn.Module, images_u8: torch.Tensor,
                     depths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """uint8 [B, 101, 101] -> fp32 probabilities [B, 2, 101, 101]."""
        logits = model(self._infer_inputs(images_u8), infer=True,
                       depth=self.depth_input(depths, images_u8.shape[0]))
        return self._to_image_space(torch.sigmoid(logits.float()))

    @torch.no_grad()
    def predict_tta_step(self, model: nn.Module, images_u8: torch.Tensor,
                         depths: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """All TTA specs of the batch in ONE forward pass of [T*B]: the
        uint8 101x101 images are transformed BEFORE the pad (the pad is
        asymmetric), the 128x128 probabilities inverse-transformed and
        aggregated before the crop; the depths repeat once per spec."""
        pp = self.config.postpro
        specs = build_tta_specs(pp.tta_flip_ud, pp.tta_flip_lr,
                                pp.tta_rotation, pp.tta_color_shift_runs)
        b = images_u8.shape[0]
        big = torch.cat([tta_transform(images_u8, s) for s in specs], dim=0)
        d = self.depth_input(depths, b)
        logits = model(self._infer_inputs(big), infer=True,
                       depth=None if d is None else d.repeat(len(specs), 1))
        probs = torch.sigmoid(logits.float())                 # [T*B,2,H,W]
        outs = [tta_inverse_transform(probs[i * b:(i + 1) * b], s)
                for i, s in enumerate(specs)]
        agg = aggregate(torch.stack(outs), pp.tta_aggregation_method)
        return self._to_image_space(agg)

    def predict_dataset(self, model: nn.Module, images: np.ndarray,
                        depths: Optional[np.ndarray] = None,
                        batch_size: int = 0, tta: bool = False,
                        chunk: int = 2048) -> np.ndarray:
        """uint8 [N, 101, 101] (and depths [N]) -> fp32 [N, 2, 101, 101].
        Ragged chunks are padded with zero images (and zero depths) to a
        batch multiple and the padding is dropped afterwards."""
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
            d = None
            if self.use_depth and depths is not None:
                d = torch.from_numpy(pad_batch(
                    np.asarray(depths[lo:lo + count], np.float32)
                    .reshape(-1, 1), bs)).to(self.device)
            probs = torch.cat([
                step(model, imgs[i:i + bs], None if d is None else d[i:i + bs])
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
