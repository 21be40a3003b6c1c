"""The second-level stacking runner (counterpart of
``salt_tpu/train/stacking.py``; reference: loaders.py:338-392,564-579,
main.py:304-344): StackingFCN(±depth) trained on the stacked salt
probabilities of M first-level models.

A ``SegmentationRunner`` whose inputs are float [B, 101, 101, M]
probability cubes in place of uint8 images: resized to the network size
(loader_mode "stacking", set on the config before the parent reads it,
as JAX does), with no augmentation, normalization or depth channels (the
reference's stacking loader has none, main.py:110-113); masks resized
and re-binarized at 0.5. Its predictions are resized back to 101x101.
``fit``, ``validate`` and ``predict_dataset`` drive it unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch

from salt_tpu_torch.ops.preprocess import one_hot_target, resize_hw
from salt_tpu_torch.train.state import TrainState
from salt_tpu_torch.train.steps import SegmentationRunner


class StackingRunner(SegmentationRunner):
    def __init__(self, config, device="cuda"):
        config.execution.loader_mode = "stacking"
        super().__init__(config, device)

    def _cube_input(self, cubes: torch.Tensor) -> torch.Tensor:
        """[B, 101, 101, M] -> fp32 [B, M, H, W], resized."""
        x = cubes.to(torch.float32).permute(0, 3, 1, 2)
        return resize_hw(x, self._net_hw).contiguous(
            memory_format=self._memory_format)

    def _train_inputs(self, cubes: torch.Tensor, masks_u8: torch.Tensor):
        """The network input [B, M, H, W] and the one-hot target
        [B, H, W, 2]; no augmentation."""
        m = resize_hw((masks_u8 > 0).to(torch.float32), self._net_hw)
        return self._cube_input(cubes), one_hot_target(
            (m > 0.5).to(torch.float32))

    def train_step(self, state: TrainState, cubes: torch.Tensor,
                   masks_u8: torch.Tensor, generator: torch.Generator,
                   depths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on [B, 101, 101, M] cubes; only dropout draws from
        ``generator``."""
        x, y = self._train_inputs(cubes, masks_u8)
        return self.update(state, x, y, generator, depths)

    def _infer_inputs(self, cubes: torch.Tensor) -> torch.Tensor:
        return self._cube_input(cubes).to(self.dtype)
