"""Train state and optimizer (counterpart of ``salt_tpu/train/state.py``
:36-71).

The optimizer is the JAX package's: L2 added to the gradient before the
Adam moments (optax ``add_decayed_weights`` then ``adam``, eps 1e-8),
over every parameter, which is ``torch.optim.Adam(weight_decay=...)``,
not AdamW. The learning rate lives in the param group, readable and
settable between steps as ``TrainState.learning_rate`` /
``with_learning_rate`` are in the JAX package.

Where the JAX state is an immutable pytree replaced every step, the
port's holds the module and the optimizer and updates them in place (no
second copy of the parameters or moments is ever made).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from salt_tpu_torch.models.convert import to_flax_flat

#: key prefix of the port's optimizer state in a ``last`` checkpoint
OPT_PREFIX = "torch_adam"


def make_optimizer(model: nn.Module, lr: float,
                   weight_decay: float = 0.0) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)


class TrainState:
    """The model being trained, its Adam optimizer and the step count."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Adam,
                 step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step = step

    @property
    def learning_rate(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    def with_learning_rate(self, lr: float) -> "TrainState":
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)
        return self

    def variables(self) -> Dict[str, np.ndarray]:
        """The model as the JAX package's flat ``params/...`` and
        ``batch_stats/...`` arrays (what ``best.npz`` holds)."""
        return to_flax_flat(self.model)

    def last_arrays(self) -> Dict[str, np.ndarray]:
        """:meth:`variables` plus the Adam moments, the step and the
        learning rate under ``torch_adam/...`` (what ``last.npz`` holds)."""
        arrays = self.variables()
        names = {id(p): n for n, p in self.model.named_parameters()}
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                st = self.optimizer.state.get(p, {})
                for k in ("exp_avg", "exp_avg_sq"):
                    if k in st:
                        arrays[f"{OPT_PREFIX}/{names[id(p)]}/{k}"] = (
                            st[k].detach().cpu().numpy().copy())
        arrays[f"{OPT_PREFIX}/step"] = np.asarray(self.step, np.int64)
        arrays[f"{OPT_PREFIX}/lr"] = np.asarray(self.learning_rate,
                                                np.float64)
        return arrays

    def load_optimizer_arrays(self, arrays: Dict[str, np.ndarray],
                              source: str = "") -> None:
        """Restore what :meth:`last_arrays` saved of the optimizer. A
        ``last`` checkpoint the JAX package wrote holds optax state, which
        the port does not read."""
        if f"{OPT_PREFIX}/step" not in arrays:
            raise ValueError(
                f"{source or 'checkpoint'} holds no {OPT_PREFIX}/ optimizer "
                "state: resuming the optimizer from a checkpoint the JAX "
                "package wrote is not supported (its optax state has "
                "another layout); train from its best.npz with "
                "execution.fine_tuning instead")
        self.step = int(arrays[f"{OPT_PREFIX}/step"])
        for name, p in self.model.named_parameters():
            st = self.optimizer.state[p]
            for k in ("exp_avg", "exp_avg_sq"):
                # empty_like keeps the parameter's device and memory format
                st[k] = torch.empty_like(p).copy_(torch.from_numpy(
                    arrays[f"{OPT_PREFIX}/{name}/{k}"]))
            st["step"] = torch.tensor(float(self.step))
        self.with_learning_rate(float(arrays[f"{OPT_PREFIX}/lr"]))
