"""Sustained hflip-TTA and train throughput of a runner on its device
(counterpart of ``salt_tpu/train/throughput.py`` :27-60, the probe
behind the JAX package's bench.py).

The timing discipline for the card:

- inputs staged on the device once, so a rate is the device's and the
  host's dispatch, not the host-to-device copy (serve's end-to-end rate,
  ``pipeline/serving.py``, includes the copy);
- ``iters`` chained steps per window and one synchronization at the end
  of each window (the host clock then covers the device's work);
- the best of ``windows`` windows, after one untimed warm-up step.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from salt_tpu_torch.tools.timing import sync


def _best_rate(device: torch.device, step, batch: int, iters: int,
               windows: int) -> float:
    """Images per second of ``step()`` over ``batch`` images: the best of
    ``windows`` windows of ``iters`` steps, after one warm-up step."""
    step()
    sync(device)
    best = 0.0
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        sync(device)
        best = max(best, batch * iters / (time.perf_counter() - t0))
    return best


def measure_tta_throughput(runner, state, batch: int, iters: int = 25,
                           windows: int = 3) -> float:
    """Sustained hflip-TTA inference images/s of ``runner`` on its
    device: ``runner.predict_tta_step`` on ``batch`` random uint8 images
    (numpy seed 0). ``state`` is the model to run (``runner.init_model``
    / ``restore``) or a ``TrainState``, whose model then runs in eval
    mode at its training precision."""
    model = getattr(state, "model", state).eval()
    images = (np.random.RandomState(0).rand(batch, 101, 101) * 255
              ).astype(np.uint8)
    img_d, = runner.device_batch(images)
    return _best_rate(runner.device,
                      lambda: runner.predict_tta_step(model, img_d), batch,
                      iters, windows)


def measure_train_throughput(runner, state, batch: int, iters: int = 15,
                             windows: int = 3) -> float:
    """Sustained train images/s of ``runner`` on its device:
    ``runner.train_step`` (augmentation, forward, loss, backward, Adam)
    on ``batch`` random uint8 images and masks (numpy seed 0), the
    augmentation drawn from one generator on the device seeded per
    step. ``state`` is a ``TrainState`` and trains."""
    rng = np.random.RandomState(0)
    images = (rng.rand(batch, 101, 101) * 255).astype(np.uint8)
    masks = (rng.rand(batch, 101, 101) > 0.5).astype(np.uint8)
    img_d, msk_d = runner.device_batch(images, masks)
    generator = torch.Generator(device=runner.device)
    count = [0]

    def step():
        generator.manual_seed(count[0])
        count[0] += 1
        return runner.train_step(state, img_d, msk_d, generator)

    return _best_rate(runner.device, step, batch, iters, windows)
