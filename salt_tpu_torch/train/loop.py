"""The fit loop: epochs of train steps and a full validation pass with the
threshold sweep (counterpart of ``salt_tpu/train/loop.py`` :36-192).

- Batches are slices of the packed arrays (uint8 images and masks; a
  stacking runner's float probability cubes, a distillation runner's
  uint16 target packs), shuffled by
  ``np.random.RandomState(seed)`` as in the JAX package, so the batch
  order is the same in both; each goes to the device one batch ahead
  (``data.pipeline.prefetch_to_device``).
- Every step reseeds one ``torch.Generator`` on the runner's device from
  (seed, epoch, batch): the augmentation draws are reproducible, but
  they are not JAX's bits.
- Depths ride with their images as [B, 1] fp32 when the runner's
  ``use_depth`` is set: the data tuples are (images, masks, depths), and
  a missing depth array feeds zeros, as in the JAX package (:42-61,
  104-147).
- Validation scores every image at all 21 sweep thresholds in one pass
  per batch and replays the reference's greedy selection on the [21]
  vector (reference: callbacks.py:503-513).
- Traced (``core/tracing.py``) as the root span ``fit`` over ``fit.epoch``
  spans; each holds a ``fit.step`` a batch (``fit.feed``, the runner's
  ``fit.augment``, ``fit.forward``, ``fit.backward`` and
  ``fit.optimizer``, then ``fit.loss_read`` and ``fit.callbacks``) and
  the epoch's ``fit.validate``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from salt_tpu_torch.core.logging import get_logger
from salt_tpu_torch.core.tracing import span
from salt_tpu_torch.data.pipeline import (batch_count, batch_indices,
                                          prefetch_to_device)
from salt_tpu_torch.train.callbacks import CallbackList
from salt_tpu_torch.train.state import TrainState
from salt_tpu_torch.train.steps import (SWEEP_THRESHOLDS, SegmentationRunner,
                                        pad_batch)

logger = get_logger()


def step_seed(seed: int, epoch_id: int, batch_id: int) -> int:
    """The augmentation seed of one step (the JAX package folds
    ``epoch * 100003 + batch`` into its key the same way)."""
    return (seed * 1_000_003 + epoch_id * 100_003 + batch_id) % (1 << 63)


def _depth_batch(runner: SegmentationRunner, depths: Optional[np.ndarray],
                 idx, bs: int) -> Optional[np.ndarray]:
    """The [bs, 1] fp32 depths of ``depths[idx]`` zero-padded to ``bs``
    (zeros without depths); None when the runner takes no depth."""
    if not runner.use_depth:
        return None
    if depths is None:
        return np.zeros((bs, 1), np.float32)
    return pad_batch(np.asarray(depths[idx], np.float32).reshape(-1, 1), bs)


def validate(runner: SegmentationRunner, state: TrainState,
             images: np.ndarray, masks: np.ndarray,
             depths: Optional[np.ndarray] = None,
             compute_loss: bool = True) -> Dict[str, float]:
    """Full-validation metrics with the reference's threshold-sweep
    semantics: {'sum', 'iou', 'iout', 'threshold'}. The last batch is
    padded with zero images (and zero depths) to the inference batch
    size and the padding dropped from the metrics (the loss keeps it, as
    in the JAX package)."""
    model = state.model
    model.eval()
    bs = runner.config.training.batch_size_inference
    n = images.shape[0]
    thresholds = torch.tensor(SWEEP_THRESHOLDS, dtype=torch.float32,
                              device=runner.device)
    iou_chunks, iout_chunks, losses = [], [], []
    for lo in range(0, n, bs):
        count = min(bs, n - lo)
        img_d, msk_d = runner.device_batch(pad_batch(images[lo:lo + bs], bs),
                                           pad_batch(masks[lo:lo + bs], bs))
        d = _depth_batch(runner, depths, slice(lo, lo + bs), bs)
        d_d = None if d is None else runner.device_batch(d)[0]
        probs = runner.predict_step(model, img_d, d_d)
        iou_t, iout_t = runner.metrics_step(probs[:, 1], msk_d, thresholds)
        iou_chunks.append(iou_t[:, :count])
        iout_chunks.append(iout_t[:, :count])
        if compute_loss:
            losses.append(runner.val_loss_step(model, img_d, msk_d, d_d))
    iou_all = torch.cat(iou_chunks, dim=1).cpu().numpy()      # [21, N]
    iout_all = torch.cat(iout_chunks, dim=1).cpu().numpy()
    iout_by_t = iout_all.mean(axis=1)

    # greedy sweep: walk 0.5 -> 0.3, stop at the first threshold that
    # does not improve
    best_iout, best_idx = 0.0, 0
    for t_idx in range(len(SWEEP_THRESHOLDS)):
        if iout_by_t[t_idx] > best_iout:
            best_iout, best_idx = float(iout_by_t[t_idx]), t_idx
        else:
            break
    loss_values = [float(v) for v in torch.stack(losses).cpu()] if losses else []
    return {
        "sum": float(np.mean(loss_values)) if loss_values else float("nan"),
        "iou": float(iou_all[best_idx].mean()),
        "iout": best_iout,
        "threshold": float(np.float32(SWEEP_THRESHOLDS[best_idx])),
    }


def fit(runner: SegmentationRunner,
        train_data: Tuple[np.ndarray, ...],
        valid_data: Optional[Tuple[np.ndarray, ...]] = None,
        callbacks: Optional[CallbackList] = None,
        state: Optional[TrainState] = None,
        epochs: Optional[int] = None,
        seed: int = 1234,
        start_epoch: int = 0) -> Tuple[TrainState, list]:
    """Train on packed arrays: ``train_data`` / ``valid_data`` are
    (images [N, 101, 101], masks [N, 101, 101]) or those and the depths
    [N] (or None). Images are uint8, or whatever the runner's
    ``train_step`` and ``predict_step`` take (``StackingRunner``: float
    [N, 101, 101, M] cubes); the train masks are uint8, or the targets
    its ``train_step`` takes (``DistillRunner``: uint16 packs); the
    validation masks are uint8."""
    with span("fit"):
        return _fit(runner, train_data, valid_data, callbacks, state, epochs,
                    seed, start_epoch)


def _fit(runner, train_data, valid_data, callbacks, state, epochs, seed,
         start_epoch) -> Tuple[TrainState, list]:
    cfg = runner.config
    images, masks, depths = (*train_data, None)[:3]
    bs = min(cfg.training.batch_size_train, images.shape[0])
    epochs = epochs if epochs is not None else cfg.training.epochs
    callbacks = callbacks or CallbackList([])
    if state is None:
        state = runner.init_state(seed)

    host_rng = np.random.RandomState(seed)
    generator = torch.Generator(device=runner.device)
    history = []
    # the schedulers start from the STATE's lr: a resumed optimizer
    # carries the schedule's position
    ctx = {"state": state, "learning_rate": state.learning_rate,
           "epoch_id": max(start_epoch - 1, 0), "batch_id": 0,
           "batch_loss": 0.0}
    callbacks.on_train_begin(ctx)
    if "force_learning_rate" in ctx:
        state.with_learning_rate(ctx.pop("force_learning_rate"))

    for epoch_id in range(start_epoch, epochs):
        with span("fit.epoch", epoch=epoch_id):
            ctx["epoch_id"] = epoch_id
            # only FRESH validation results reach the callbacks
            ctx.pop("validation", None)
            callbacks.on_epoch_begin(ctx)
            epoch_losses = []

            def host_batches():
                for idx in batch_indices(images.shape[0], bs,
                                         cfg.execution.shuffle, host_rng):
                    d = _depth_batch(runner, depths, idx, len(idx))
                    yield ((images[idx], masks[idx])
                           + (() if d is None else (d,)))

            feed = prefetch_to_device(host_batches(), runner.device_batch)
            for batch_id in range(batch_count(images.shape[0], bs)):
                with span("fit.step"):
                    with span("fit.feed"):
                        img_d, msk_d, *d_d = next(feed)
                    generator.manual_seed(step_seed(seed, epoch_id, batch_id))
                    loss = runner.train_step(state, img_d, msk_d, generator,
                                             *d_d)
                    with span("fit.loss_read"):
                        epoch_losses.append(float(loss))
                    ctx.update(state=state, batch_id=batch_id,
                               batch_loss=epoch_losses[-1])
                    with span("fit.callbacks"):
                        callbacks.on_batch_end(ctx)
                    if "force_learning_rate" in ctx:
                        state.with_learning_rate(
                            ctx.pop("force_learning_rate"))
            ctx["train_loss"] = (float(np.mean(epoch_losses))
                                 if epoch_losses else None)

            if valid_data is not None and (
                    epoch_id % cfg.training.validate_every_n_epochs == 0):
                with span("fit.validate"):
                    val = validate(runner, state, *valid_data)
                ctx["validation"] = val
                logger.info("epoch %d validation sum: %.5f iou: %.5f "
                            "iout: %.5f (threshold %.2f)", epoch_id,
                            val["sum"], val["iou"], val["iout"],
                            val["threshold"])
            callbacks.on_epoch_end(ctx)
            history.append({"epoch": epoch_id,
                            "train_loss": ctx.get("train_loss"),
                            **{f"val_{k}": v for k, v in
                               (ctx.get("validation") or {}).items()}})
            new_lr = callbacks.new_learning_rate(ctx)
            if new_lr is not None:
                state.with_learning_rate(new_lr)
                ctx["learning_rate"] = new_lr
            if callbacks.training_break(ctx):
                logger.info("early stopping at epoch %d", epoch_id)
                ctx["early_stopped"] = True
                break
    callbacks.on_train_end(ctx)
    return state, history
