"""Experiment orchestration: single-fold training (counterpart of the
``train`` path of ``salt_tpu/pipeline/api.py`` :53-246).

- Training uses the FIRST depth-stratified fold (reference:
  main.py:458-462), with the reference's DEV_MODE subsampling.
- Checkpoints go under ``checkpoints/network/`` in the flat format both
  packages read; the full config is persisted as ``config.json`` so
  ``serve`` (either package's) rebuilds the trained network from the
  experiment dir alone.
- ``execution.resume`` continues from the ``last`` checkpoint (the
  port's own Adam state), ``execution.fine_tuning`` restarts from
  ``best``.

The CV loops, ``evaluate`` / ``predict`` and auxiliary data are not
ported yet (ROADMAP.md Queue A).
"""
from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch

from salt_tpu_torch.core.config import Config
from salt_tpu_torch.core.experiment import Experiment
from salt_tpu_torch.core.logging import get_logger
from salt_tpu_torch.data.bundle import DataBundle
from salt_tpu_torch.data.kfold import KFoldBySortedValue
from salt_tpu_torch.models.convert import load_flax_flat
from salt_tpu_torch.train.callbacks import (CallbackList, ChannelLogger,
                                            EarlyStopping, ExperimentTiming,
                                            ExponentialLRScheduler,
                                            InitialLearningRateFinder,
                                            ModelCheckpoint,
                                            ReduceLROnPlateauScheduler,
                                            TrainingMonitor)
from salt_tpu_torch.train.loop import fit
from salt_tpu_torch.train.state import TrainState
from salt_tpu_torch.train.steps import SegmentationRunner

logger = get_logger()

NETWORK = "network"


def _first_fold(config: Config, bundle: DataBundle):
    cv = KFoldBySortedValue(n_splits=config.execution.n_cv_splits)
    train_idx, valid_idx = next(iter(cv.split(bundle.meta["z"].values)))
    return train_idx, valid_idx


def _bundle_tuple(b: DataBundle) -> Tuple[np.ndarray, np.ndarray]:
    return b.images, b.masks


def _lr_schedule_callbacks(t) -> List:
    """The scheduler callback the config selects (reference:
    models.py:300-312)."""
    schedule = (t.lr_schedule or "none").lower()
    if schedule == "plateau":
        return [ReduceLROnPlateauScheduler(t.validation_metric_name,
                                           t.minimize_validation_metric,
                                           t.reduce_factor,
                                           t.reduce_patience, t.min_lr)]
    if schedule == "exponential":
        return [ExponentialLRScheduler(t.gamma)]
    if schedule in ("lr_finder", "lr-finder"):
        return [InitialLearningRateFinder()]
    if schedule == "none":
        return []
    raise ValueError(f"unknown training.lr_schedule {t.lr_schedule!r} "
                     "(want plateau | exponential | lr_finder | none)")


def _make_callbacks(config: Config, experiment: Experiment,
                    name: str) -> CallbackList:
    # every fit passes through here once per trained model: persist the
    # config so serve rebuilds the trained architecture
    experiment.save_json("config", config.to_dict())
    t = config.training
    if t.validation_images_every:
        raise NotImplementedError(
            "training.validation_images_every: the validation image "
            "monitor is not ported yet (ROADMAP.md Queue A item 12)")
    return CallbackList([
        ExperimentTiming(),
        TrainingMonitor(epoch_every=1),
        ModelCheckpoint(experiment, name,
                        metric_name=t.validation_metric_name,
                        minimize=t.minimize_validation_metric,
                        resume=config.execution.resume),
        *_lr_schedule_callbacks(t),
        EarlyStopping(t.validation_metric_name, t.patience,
                      t.minimize_validation_metric),
        ChannelLogger(experiment.directory + f"/channels_{name}.jsonl"),
    ])


def _load_best(runner: SegmentationRunner, experiment: Experiment,
               name: str) -> TrainState:
    """A fresh train state holding the persisted best weights (either
    package's ``best.npz``), on the device once."""
    state = runner.init_state(runner.config.execution.seed)
    load_flax_flat(state.model, experiment.load_params(name))
    return state


def load_last(runner: SegmentationRunner, experiment: Experiment,
              name: str) -> Tuple[TrainState, int]:
    """Restore the crash-recovery checkpoint with the optimizer state;
    returns (state, next_epoch)."""
    state = runner.init_state(runner.config.execution.seed)
    arrays = experiment.load_params(name, tag="last")
    state.load_optimizer_arrays(arrays, experiment.checkpoint_path(name,
                                                                   "last"))
    load_flax_flat(state.model, {k: v for k, v in arrays.items()
                                 if k.startswith(("params/", "batch_stats/"))})
    meta = experiment.load_meta(name, tag="last")
    return state, int(meta.get("epoch", -1)) + 1


def _with_auxiliary(config: Config, train_b: DataBundle) -> DataBundle:
    if config.execution.use_auxiliary_data:
        raise NotImplementedError(
            "execution.use_auxiliary_data: auxiliary small-mask crops are "
            "not ported yet (ROADMAP.md Queue A item 16)")
    return train_b


def _fit_fold(config: Config, experiment: Experiment, name: str,
              train_b: DataBundle, valid_b: DataBundle,
              runner: SegmentationRunner) -> SegmentationRunner:
    state = None
    start_epoch = 0
    if (config.execution.resume
            and experiment.train_finished(name, config.training.epochs)):
        logger.info("resume: %s training already finished, skipping fit",
                    name)
        return runner
    if (config.execution.resume
            and experiment.has_checkpoint(name, tag="last")):
        logger.info("resuming %s from the last checkpoint", name)
        state, start_epoch = load_last(runner, experiment, name)
        if start_epoch >= config.training.epochs:
            logger.info("resume: %s already at the epoch budget, "
                        "skipping fit", name)
            return runner
    elif config.execution.fine_tuning and experiment.has_checkpoint(name):
        logger.info("fine-tuning %s from persisted checkpoint", name)
        state = _load_best(runner, experiment, name)
    callbacks = _make_callbacks(config, experiment, name)
    fit(runner, _bundle_tuple(train_b), _bundle_tuple(valid_b),
        callbacks=callbacks, state=state, seed=config.execution.seed,
        start_epoch=start_epoch)
    return runner


def train(config: Config, experiment: Experiment, bundle: DataBundle,
          device: Union[str, torch.device] = "cuda") -> SegmentationRunner:
    """Single-fold training on the first depth-stratified fold
    (reference: main.py:454-488), on ``device`` (CUDA unless the caller
    asks for the CPU)."""
    runner = SegmentationRunner(config, device)
    train_idx, valid_idx = _first_fold(config, bundle)
    train_b, valid_b = bundle.take(train_idx), bundle.take(valid_idx)
    train_b = _with_auxiliary(config, train_b)
    if config.execution.dev_mode:
        train_b = train_b.dev_sample(config.execution.dev_mode_size,
                                     config.execution.seed)
        valid_b = valid_b.dev_sample(config.execution.dev_mode_size // 2,
                                     config.execution.seed)
    return _fit_fold(config, experiment, NETWORK, train_b, valid_b, runner)
