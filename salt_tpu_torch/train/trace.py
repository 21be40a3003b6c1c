"""Per-phase train step times (counterpart of ``salt_tpu/train/trace.py``
:33-110): each phase of the step run on its own and timed, an
attribution of the step's time:

  h2d        host -> device batch transfer (``runner.device_batch``)
  aug        the augmentation's draws and the train inputs
             (``draw_augment_params`` + ``_train_inputs``)
  fwd_loss   forward + loss in train mode (BN statistics move), no
             gradient
  full       the train step (``runner.train_step``)
  bwd_opt    derived: full - fwd_loss (backward + Adam)

A phase's time is the best of 3 windows of ``iters`` calls after one
untimed call: on the card each window timed by CUDA events around its
launches (``tools/timing.window_ms``), on the CPU by the host clock (a
CPU's time, not the card's). ``full`` and ``bwd_opt`` are the ones to
trust; the isolated phases are indicative. The phases append to a
``channels_trace.jsonl`` next to the training channels.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, Optional

import numpy as np
import torch

from salt_tpu_torch.ops.augment import draw_augment_params
from salt_tpu_torch.tools.timing import sync, window_ms

PHASES = ("h2d", "aug", "fwd_loss", "full", "bwd_opt")


def _time(device: torch.device, fn: Callable[[int], object], iters: int,
          windows: int = 3) -> float:
    fn(0)
    sync(device)
    return min(window_ms(device, fn, iters) for _ in range(windows))


def trace_steps(runner, images_u8: np.ndarray, masks_u8: np.ndarray,
                depths: Optional[np.ndarray] = None, iters: int = 10,
                out_path: str = "") -> Dict[str, float]:
    """Per-phase times (ms) of ``runner``'s train step on one batch of
    uint8 images and masks (and depths) on its device, from a fresh
    ``init_state(0)``; appended to ``out_path`` as JSONL lines
    {"kind": "trace", "phase", "ms", "batch_size"} when given."""
    dev = runner.device
    bs, h, w = images_u8.shape
    if depths is not None:
        depths = np.asarray(depths, np.float32).reshape(bs, 1)
    host = (images_u8, masks_u8) + (() if depths is None else (depths,))
    results: Dict[str, float] = {}
    results["h2d"] = _time(dev, lambda i: runner.device_batch(*host), iters)

    di, dm, *dd = runner.device_batch(*host)
    dd = dd[0] if dd else None
    generator = torch.Generator(device=dev)

    def aug(i):
        generator.manual_seed(i)
        return runner._train_inputs(di, dm, draw_augment_params(
            generator, bs, h, w))
    results["aug"] = _time(dev, aug, iters)

    state = runner.init_state(0)
    model = state.model

    @torch.no_grad()
    def fwd_loss(i):
        x, y = aug(i)
        model.train()
        logits = model(x, generator, depth=runner.depth_input(dd, bs))
        return runner.train_loss(logits, y)
    results["fwd_loss"] = _time(dev, fwd_loss, iters)

    def full(i):
        generator.manual_seed(i)
        return runner.train_step(state, di, dm, generator, dd)
    results["full"] = _time(dev, full, iters)
    results["bwd_opt"] = max(results["full"] - results["fwd_loss"], 0.0)

    if out_path:
        with open(out_path, "a") as f:
            for phase, ms in results.items():
                f.write(json.dumps({"kind": "trace", "phase": phase,
                                    "ms": round(ms, 3),
                                    "batch_size": bs}) + "\n")
    return results
