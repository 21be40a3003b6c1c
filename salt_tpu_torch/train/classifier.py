"""The empty-vs-salt classifier's runner and epoch loop (counterpart of
``salt_tpu/train/classifier.py``; reference: empty_vs_non_empty.py's
EmptinessLoader, EmptinessClassifier and ValidationMonitorEmptiness,
callbacks.py:618-755).

``ClassifierRunner`` shares the model's device, precision and optimizer
with ``SegmentationRunner`` (fp32 parameters computing in
``training.dtype`` under autocast while training, the cast model when
restored; channels_last on the card only) and has its own inputs and
steps, as the JAX runner (:59-77):
- training: the augmentation of ``augment_batch_images`` (the image's
  ops of the segmentation policy, drawn from a ``torch.Generator``),
  then resize 102 and pad 13 (or a resize in ``resize`` mode);
- inference: pad to a multiple of 64 (or a resize); both then normalize
  and add the depth channels, with plain ops (the JAX runner uses no
  kernel here);
- predict: P = sigmoid(logits) [B, 2], column 1 P(non-empty) (the
  reference reads ``y[1, 0, 0]``, empty_vs_non_empty.py:639-642).

``fit_classifier`` is the JAX loop (:141-209), not ``fit``: the ragged
tail is dropped, every epoch is scored by ROC-AUC on the host, and the
callbacks see ``validation = {"sum": nan, "auc": auc}``. Batches follow
``np.random.RandomState(seed)`` as in JAX; the augmentation of a step
draws from one generator reseeded by ``loop.step_seed``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from salt_tpu_torch.core.logging import get_logger
from salt_tpu_torch.metrics.auc import roc_auc
from salt_tpu_torch.models.registry import init_flax_like
from salt_tpu_torch.ops.augment import (AugmentParams, apply_augment_images,
                                        draw_augment_params)
from salt_tpu_torch.ops.preprocess import (add_depth_channels, normalize_gray,
                                           pad_fixed, pad_to_divisor,
                                           resize_hw)
from salt_tpu_torch.train.callbacks import CallbackList
from salt_tpu_torch.train.loop import step_seed
from salt_tpu_torch.train.state import TrainState
from salt_tpu_torch.train.steps import SegmentationRunner, pad_batch

logger = get_logger()


class ClassifierRunner(SegmentationRunner):
    """EmptinessClassifier training and inference on ``device``."""

    def init_state(self, seed: int = 1234) -> TrainState:
        """Flax's default initializers, seeded (no pretrained graft: the
        JAX runner has none)."""
        return self.train_state(init_flax_like(self.build(), seed))

    def _prep_train(self, images_u8: torch.Tensor,
                    params: AugmentParams) -> torch.Tensor:
        """uint8 [B, 101, 101] -> the fp32 network input [B, 3, H, W]
        (channels_last) of a train step, augmented with ``params``."""
        x = apply_augment_images(params, images_u8.to(torch.float32) / 255.0)
        if self._pp["loader_mode"] == "resize":
            x = resize_hw(x, self._net_hw)
        else:
            x = resize_hw(x, (self._pp["resize_size"],) * 2)
            x = pad_fixed(x, (self._pp["pad_size"],) * 2,
                          self._pp["pad_method"])
        return add_depth_channels(normalize_gray(x)).permute(0, 3, 1, 2)

    def _prep_infer(self, images_u8: torch.Tensor) -> torch.Tensor:
        """uint8 [B, 101, 101] -> the network input [B, 3, 128, 128] in the
        compute dtype, channels_last."""
        x = images_u8.to(torch.float32) / 255.0
        if self._pp["loader_mode"] == "resize":
            x = resize_hw(x, self._net_hw)
        else:
            x = pad_to_divisor(x, 64, self._pp["pad_method"])
        x = add_depth_channels(normalize_gray(x)).to(self.dtype)
        return x.permute(0, 3, 1, 2)

    def train_loss(self, logits: torch.Tensor, y: torch.Tensor
                   ) -> torch.Tensor:
        """``training.loss`` over [B, 1, 1, 2] logits and the one-hot
        pair, as the JAX step reshapes them."""
        return self.loss_fn(logits[:, None, None, :], y[:, None, None, :])

    def train_step(self, state: TrainState, images_u8: torch.Tensor,
                   labels: torch.Tensor, generator: torch.Generator
                   ) -> torch.Tensor:
        """One step on uint8 images and float labels {0, 1} (is not
        empty); the target is the one-hot pair (reference:
        loaders.py:778-783)."""
        b, h, w = images_u8.shape
        x = self._prep_train(images_u8,
                             draw_augment_params(generator, b, h, w))
        y = torch.stack([1.0 - labels, labels], dim=-1)
        return self.update(state, x, y, generator)

    @torch.no_grad()
    def predict_step(self, model: torch.nn.Module,
                     images_u8: torch.Tensor) -> torch.Tensor:
        """uint8 [B, 101, 101] -> fp32 sigmoid probabilities [B, 2]."""
        return torch.sigmoid(model(self._prep_infer(images_u8)).float())

    def predict_dataset(self, model: torch.nn.Module, images: np.ndarray,
                        batch_size: int = 0) -> np.ndarray:
        """[N, 2] probabilities of uint8 [N, 101, 101] images, column 1
        P(non-empty); the last batch padded with zero images."""
        bs = batch_size or self.config.training.batch_size_inference
        n = images.shape[0]
        if n == 0:
            return np.zeros((0, 2), np.float32)
        model.eval()
        imgs = torch.from_numpy(pad_batch(images, bs)).to(self.device)
        probs = torch.cat([self.predict_step(model, imgs[i:i + bs])
                           for i in range(0, imgs.shape[0], bs)])
        return probs[:n].cpu().numpy()


def fit_classifier(runner: ClassifierRunner,
                   train_data: Tuple[np.ndarray, np.ndarray],
                   valid_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                   epochs: Optional[int] = None, seed: int = 1234,
                   callbacks: Optional[CallbackList] = None
                   ) -> Tuple[TrainState, list]:
    """Epochs of train steps, each scored by ROC-AUC on ``valid_data``
    (reference: callbacks.py:662-675). ``train_data`` = (uint8 images
    [N, 101, 101], labels [N] {0, 1})."""
    cfg = runner.config
    images, labels = train_data
    bs = min(cfg.training.batch_size_train, images.shape[0])
    epochs = epochs if epochs is not None else cfg.training.epochs
    callbacks = callbacks or CallbackList([])
    state = runner.init_state(seed)
    host_rng = np.random.RandomState(seed)
    generator = torch.Generator(device=runner.device)
    history = []
    ctx = {"state": state, "learning_rate": state.learning_rate,
           "epoch_id": 0, "batch_id": 0, "batch_loss": 0.0}
    callbacks.on_train_begin(ctx)

    for epoch_id in range(epochs):
        ctx["epoch_id"] = epoch_id
        callbacks.on_epoch_begin(ctx)
        idx = np.arange(images.shape[0])
        if cfg.execution.shuffle:
            host_rng.shuffle(idx)
        epoch_losses = []
        for batch_id, lo in enumerate(range(0, len(idx) - bs + 1, bs)):
            take = idx[lo:lo + bs]
            img_d, lab_d = runner.device_batch(
                images[take], labels[take].astype(np.float32))
            generator.manual_seed(step_seed(seed, epoch_id, batch_id))
            loss = runner.train_step(state, img_d, lab_d, generator)
            epoch_losses.append(float(loss))
            ctx.update(state=state, batch_id=batch_id,
                       batch_loss=epoch_losses[-1])
            callbacks.on_batch_end(ctx)
        ctx["train_loss"] = (float(np.mean(epoch_losses))
                             if epoch_losses else None)

        if valid_data is not None:
            v_images, v_labels = valid_data
            probs = runner.predict_dataset(state.model, v_images)
            auc = roc_auc(v_labels, probs[:, 1])
            ctx["validation"] = {"sum": float("nan"), "auc": auc}
            logger.info("epoch %d validation auc: %.5f", epoch_id, auc)
        callbacks.on_epoch_end(ctx)
        history.append({"epoch": epoch_id, "train_loss": ctx.get("train_loss"),
                        **{f"val_{k}": v for k, v in
                           (ctx.get("validation") or {}).items()}})
        new_lr = callbacks.new_learning_rate(ctx)
        if new_lr is not None:
            state.with_learning_rate(new_lr)
            ctx["learning_rate"] = new_lr
        if callbacks.training_break(ctx):
            ctx["early_stopped"] = True
            break
    callbacks.on_train_end(ctx)
    return state, history
