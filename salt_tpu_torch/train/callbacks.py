"""Training callbacks (own copy of ``salt_tpu/train/callbacks.py``
:30-458): host-side control around the training loop.

Counterparts of the reference's callback suite (reference:
common_blocks/callbacks.py): TrainingMonitor (124-161), ExperimentTiming
(278-324), ExponentialLRScheduler (164-201), ReduceLROnPlateauScheduler
(204-241), InitialLearningRateFinder (244-275), ModelCheckpoint
(758-794), EarlyStopping (797-829), NeptuneMonitor (327-446, re-homed as
a JSONL channel logger since this build has no tracking server).

The expensive parts of the reference callbacks (full-validation
inference + threshold sweep inside ValidationMonitor, callbacks.py:
455-615) live in the eval steps (train/steps.py, train/loop.py);
these classes only consume the resulting metrics dict
{'sum': val_loss, 'iou': ..., 'iout': ..., 'threshold': ...}.

The port's ``ModelCheckpoint`` saves ``TrainState.variables()`` (best:
the flat flax keys, which the JAX package reads) and
``TrainState.last_arrays()`` (last: plus the port's Adam state).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from salt_tpu_torch.core.logging import get_logger

logger = get_logger()


class Averager:
    """Running mean (reference: steppy-toolkit Averager, used at
    callbacks.py:138-158)."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def send(self, value: float):
        self.sum += float(value)
        self.count += 1

    @property
    def value(self) -> float:
        return self.sum / max(self.count, 1)

    def reset(self):
        self.sum, self.count = 0.0, 0


class Callback:
    def on_train_begin(self, ctx):
        pass

    def on_train_end(self, ctx):
        pass

    def on_epoch_begin(self, ctx):
        pass

    def on_epoch_end(self, ctx):
        pass

    def on_batch_end(self, ctx):
        pass

    def training_break(self, ctx) -> bool:
        return False

    def new_learning_rate(self, ctx) -> Optional[float]:
        return None


class CallbackList(Callback):
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = callbacks

    def on_train_begin(self, ctx):
        for c in self.callbacks:
            c.on_train_begin(ctx)

    def on_train_end(self, ctx):
        for c in self.callbacks:
            c.on_train_end(ctx)

    def on_epoch_begin(self, ctx):
        for c in self.callbacks:
            c.on_epoch_begin(ctx)

    def on_epoch_end(self, ctx):
        for c in self.callbacks:
            c.on_epoch_end(ctx)

    def on_batch_end(self, ctx):
        for c in self.callbacks:
            c.on_batch_end(ctx)

    def training_break(self, ctx) -> bool:
        return any(c.training_break(ctx) for c in self.callbacks)

    def new_learning_rate(self, ctx) -> Optional[float]:
        lr = None
        for c in self.callbacks:
            v = c.new_learning_rate(ctx)
            if v is not None:
                lr = v
        return lr


class TrainingMonitor(Callback):
    """Per-epoch mean loss logging (reference: callbacks.py:124-161)."""

    def __init__(self, epoch_every: int = 1, batch_every: int = 0):
        self.epoch_every = epoch_every
        self.batch_every = batch_every
        self.averager = Averager()

    def on_epoch_begin(self, ctx):
        self.averager.reset()

    def on_batch_end(self, ctx):
        self.averager.send(ctx["batch_loss"])
        if self.batch_every and ctx["batch_id"] % self.batch_every == 0:
            logger.info("epoch %d batch %d loss: %.5f", ctx["epoch_id"],
                        ctx["batch_id"], ctx["batch_loss"])

    def on_epoch_end(self, ctx):
        ctx["train_loss"] = self.averager.value
        if self.epoch_every and ctx["epoch_id"] % self.epoch_every == 0:
            logger.info("epoch %d sum: %.5f", ctx["epoch_id"],
                        self.averager.value)


class ExperimentTiming(Callback):
    """Epoch wall time + running mean batch time
    (reference: callbacks.py:278-324)."""

    def __init__(self):
        self.epoch_start = None
        self.batch_times: List[float] = []
        self._last_batch_end = None

    def on_train_begin(self, ctx):
        logger.info("starting training...")

    def on_train_end(self, ctx):
        logger.info("training finished")

    def on_epoch_begin(self, ctx):
        self.epoch_start = time.time()
        self.batch_times = []
        self._last_batch_end = time.time()

    def on_batch_end(self, ctx):
        now = time.time()
        self.batch_times.append(now - self._last_batch_end)
        self._last_batch_end = now

    def on_epoch_end(self, ctx):
        wall = time.time() - self.epoch_start
        mean_batch = float(np.mean(self.batch_times)) if self.batch_times else 0.0
        ctx["epoch_seconds"] = wall
        ctx["mean_batch_seconds"] = mean_batch
        logger.info("epoch %d time %.2fs (mean batch %.4fs)",
                    ctx["epoch_id"], wall, mean_batch)


class ExponentialLRScheduler(Callback):
    """lr <- lr * gamma each epoch (reference: callbacks.py:164-201)."""

    def __init__(self, gamma: float, epoch_every: int = 1):
        self.gamma = gamma
        self.epoch_every = epoch_every
        self._lr = None

    def on_train_begin(self, ctx):
        self._lr = ctx["learning_rate"]
        logger.info("initial lr: %s", self._lr)

    def new_learning_rate(self, ctx) -> Optional[float]:
        if self.epoch_every and (ctx["epoch_id"] + 1) % self.epoch_every == 0:
            self._lr = self._lr * self.gamma
            return self._lr
        return None


class ReduceLROnPlateauScheduler(Callback):
    """torch-semantics plateau scheduler (reference: callbacks.py:204-241
    wraps torch ReduceLROnPlateau: rel threshold 1e-4, no cooldown)."""

    def __init__(self, metric_name: str, minimize: bool, reduce_factor: float,
                 reduce_patience: int, min_lr: float, threshold: float = 1e-4):
        self.metric_name = metric_name
        self.minimize = minimize
        self.factor = reduce_factor
        self.patience = reduce_patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = None
        self.num_bad = 0
        self._lr = None

    def on_train_begin(self, ctx):
        self._lr = ctx["learning_rate"]
        self.best = None
        self.num_bad = 0

    def _is_better(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.minimize:
            return value < self.best * (1.0 - self.threshold)
        return value > self.best * (1.0 + self.threshold)

    def new_learning_rate(self, ctx) -> Optional[float]:
        metrics = ctx.get("validation")
        if not metrics or self.metric_name not in metrics:
            return None
        value = float(metrics[self.metric_name])
        if self._is_better(value):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            new_lr = max(self._lr * self.factor, self.min_lr)
            if new_lr < self._lr:
                logger.info("epoch %d plateau: lr %.3g -> %.3g",
                            ctx["epoch_id"], self._lr, new_lr)
                self._lr = new_lr
                self.num_bad = 0
                return new_lr
            self.num_bad = 0
        return None


class InitialLearningRateFinder(Callback):
    """Geometric LR ramp per batch with loss logging
    (reference: callbacks.py:244-275)."""

    def __init__(self, min_lr: float = 1e-8, multiply_factor: float = 1.05,
                 add_factor: float = 0.0):
        self.min_lr = min_lr
        self.multiply_factor = multiply_factor
        self.add_factor = add_factor
        self._lr = None
        self.history: List[Dict[str, float]] = []

    def on_train_begin(self, ctx):
        self._lr = self.min_lr
        ctx["force_learning_rate"] = self.min_lr

    def on_batch_end(self, ctx):
        self.history.append({"lr": self._lr, "loss": ctx["batch_loss"]})
        logger.info("Learning Rate %s Loss %s", self._lr, ctx["batch_loss"])
        self._lr = self._lr * self.multiply_factor + self.add_factor
        ctx["force_learning_rate"] = self._lr


class ModelCheckpoint(Callback):
    """Persist params when the monitored metric improves
    (reference: callbacks.py:758-794). Saving goes through the
    Experiment artifact store instead of torch pickles."""

    def __init__(self, experiment, name: str, metric_name: str = "iout",
                 minimize: bool = False, epoch_every: int = 1,
                 save_last: bool = True, last_every: int = 5,
                 resume: bool = False):
        self.experiment = experiment
        self.name = name
        self.metric_name = metric_name
        self.minimize = minimize
        self.epoch_every = epoch_every
        self.save_last = save_last
        # 'last' includes the full optimizer state (~3x params on disk),
        # so write it sparsely — it's crash recovery, not the artifact
        self.last_every = last_every
        self.best_score = None
        if resume and experiment.has_checkpoint(name, tag="best"):
            # crash recovery must not let a worse post-resume epoch
            # overwrite the pre-crash best checkpoint: seed the running
            # best from the persisted best meta
            persisted = experiment.load_meta(name, tag="best")
            if metric_name in persisted:
                self.best_score = float(persisted[metric_name])
                logger.info("resume: best %s so far %.5f (checkpoint kept"
                            " unless beaten)", metric_name, self.best_score)

    def on_epoch_end(self, ctx):
        if not self.epoch_every or ctx["epoch_id"] % self.epoch_every:
            return
        if self.save_last and (ctx["epoch_id"] % self.last_every
                               == self.last_every - 1):
            self._save_last(ctx)
        metrics = ctx.get("validation") or {}
        if self.metric_name not in metrics:
            return
        score = float(metrics[self.metric_name])
        # strictly-better only: no epoch-0 force-save — with a fresh
        # start best_score is None so epoch 0 saves anyway, and after a
        # restart-from-scratch resume (best exists, no last checkpoint)
        # a forced save would clobber the pre-crash best with epoch-0
        # weights
        improved = (self.best_score is None
                    or (self.minimize and score < self.best_score)
                    or (not self.minimize and score > self.best_score))
        if improved:
            self.best_score = score
            self.experiment.save_params_async(
                self.name, ctx["state"].variables(), tag="best",
                meta={"epoch": ctx["epoch_id"], self.metric_name: score,
                      "threshold": float(metrics.get("threshold", 0.5))})
            logger.info("epoch %d model saved (%s=%.5f)", ctx["epoch_id"],
                        self.metric_name, score)

    def on_train_end(self, ctx):
        # guarantee a resumable checkpoint at run end regardless of
        # cadence; 'finished' marks a CLEAN train end (early stop or
        # epoch budget) — a crash never reaches here, so --resume can
        # skip refitting this fold entirely
        if self.save_last and "state" in ctx:
            self._save_last(ctx, finished=True,
                            early_stopped=bool(ctx.get("early_stopped")))
        self.experiment.flush_saves()

    def _save_last(self, ctx, finished: bool = False,
                   early_stopped: bool = False):
        """Crash-recovery checkpoint alongside best (the reference's
        equivalents are the steppy transformer cache +
        CLONE_EXPERIMENT_DIR_FROM, main.py:38-51). Includes the full
        optimizer state so --resume continues exactly."""
        self.experiment.save_params_async(
            self.name, ctx["state"].last_arrays(), tag="last",
            meta={"epoch": ctx["epoch_id"], "finished": finished,
                  "early_stopped": early_stopped})


class EarlyStopping(Callback):
    """Stop after ``patience`` epochs without improvement
    (reference: callbacks.py:797-829)."""

    def __init__(self, metric_name: str = "iout", patience: int = 20,
                 minimize: bool = False):
        self.metric_name = metric_name
        self.patience = patience
        self.minimize = minimize
        self.best_score = None
        self.epochs_since_best = 0
        self._break = False

    def on_epoch_end(self, ctx):
        metrics = ctx.get("validation") or {}
        if self.metric_name not in metrics:
            return
        score = float(metrics[self.metric_name])
        if self.best_score is None:
            self.best_score = score
            return
        improved = (score < self.best_score if self.minimize
                    else score > self.best_score)
        if improved:
            self.best_score = score
            self.epochs_since_best = 0
        else:
            self.epochs_since_best += 1
        if self.epochs_since_best > self.patience:
            self._break = True

    def training_break(self, ctx) -> bool:
        return self._break


class ValidationImageMonitor(Callback):
    """Save input|prediction|target triptych PNGs every ``image_every``
    epochs (``salt_tpu/train/callbacks.py`` :385-418; reference:
    NeptuneMonitor's validation image channel, callbacks.py:327-446):
    per image the uint8 input, the salt probability times 255 truncated
    to uint8 and the mask times 255, side by side, the first
    ``image_nr`` validation images stacked."""

    def __init__(self, directory: str, runner, valid_images, valid_masks,
                 valid_depths=None, image_nr: int = 8,
                 image_every: int = 10):
        self.directory = directory
        self.runner = runner
        self.images = np.asarray(valid_images)[:image_nr]
        self.masks = np.asarray(valid_masks)[:image_nr]
        self.depths = (np.asarray(valid_depths)[:image_nr]
                       if valid_depths is not None else None)
        self.image_every = image_every
        os.makedirs(directory, exist_ok=True)

    def on_epoch_end(self, ctx):
        if not self.image_every or ctx["epoch_id"] % self.image_every:
            return
        from PIL import Image
        model = ctx["state"].model
        model.eval()                  # the JAX package predicts with train=False
        probs = self.runner.predict_dataset(model, self.images, self.depths)
        rows = []
        for img, prob, mask in zip(self.images, probs, self.masks):
            gray = img.astype(np.uint8)
            pred = (prob[1] * 255).astype(np.uint8)
            tgt = (mask * 255).astype(np.uint8)
            rows.append(np.concatenate([gray, pred, tgt], axis=1))
        grid = np.concatenate(rows, axis=0)
        path = os.path.join(self.directory,
                            f"validation_epoch_{ctx['epoch_id']:04d}.png")
        Image.fromarray(grid).save(path)
        logger.info("validation image grid saved to %s", path)


class ChannelLogger(Callback):
    """JSONL metric channels — the tracking-server-free stand-in for
    NeptuneMonitor (reference: callbacks.py:327-446). One line per epoch
    with losses/metrics/lr; batch losses at a configurable cadence."""

    def __init__(self, path: str, batch_every: int = 0):
        self.path = path
        self.batch_every = batch_every
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = None

    def on_train_begin(self, ctx):
        self._fh = open(self.path, "a")

    def on_train_end(self, ctx):
        if self._fh:
            self._fh.close()
            self._fh = None

    def _write(self, payload: dict):
        if self._fh:
            self._fh.write(json.dumps(payload, default=float) + "\n")
            self._fh.flush()

    def on_batch_end(self, ctx):
        if self.batch_every and ctx["batch_id"] % self.batch_every == 0:
            self._write({"kind": "batch", "epoch": ctx["epoch_id"],
                         "batch": ctx["batch_id"],
                         "loss": ctx["batch_loss"]})

    def on_epoch_end(self, ctx):
        payload = {"kind": "epoch", "epoch": ctx["epoch_id"],
                   "train_loss": ctx.get("train_loss"),
                   "lr": ctx.get("learning_rate"),
                   "epoch_seconds": ctx.get("epoch_seconds")}
        payload.update({k: float(v) for k, v in
                        (ctx.get("validation") or {}).items()})
        self._write(payload)
