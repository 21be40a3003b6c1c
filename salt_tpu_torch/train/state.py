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

from salt_tpu_torch.models.convert import from_flax_flat, to_flax_flat

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
        """Restore the optimizer from a ``last`` checkpoint: the port's
        ``torch_adam/...`` arrays (:meth:`last_arrays`), or the optax
        state of one the JAX package wrote (:meth:`_load_optax`)."""
        if "opt_state/hyperparams/learning_rate" in arrays:
            self._load_optax(arrays, source)
            return
        if f"{OPT_PREFIX}/step" not in arrays:
            raise ValueError(f"{source or 'checkpoint'} holds no optimizer "
                             f"state ({OPT_PREFIX}/ or opt_state/)")
        self.step = int(arrays[f"{OPT_PREFIX}/step"])
        self._set_moments(
            {k: {name: torch.from_numpy(arrays[f"{OPT_PREFIX}/{name}/{k}"])
                 for name, _ in self.model.named_parameters()}
             for k in ("exp_avg", "exp_avg_sq")}, self.step)
        self.with_learning_rate(float(arrays[f"{OPT_PREFIX}/lr"]))

    def _load_optax(self, arrays: Dict[str, np.ndarray], source: str) -> None:
        """The JAX package's ``opt_state`` (``salt_tpu/train/state.py``
        :36-47: ``inject_hyperparams(chain(add_decayed_weights?, adam))``):
        ``hyperparams/learning_rate`` is the learning rate, and the Adam
        state sits at ``inner_state/<i>/0/`` (i = 1 behind the L2 term's
        empty state, else 0): its ``mu`` / ``nu`` per parameter are
        ``exp_avg`` / ``exp_avg_sq`` through the weight bridge, its
        ``count`` Adam's step. The top-level ``step`` is the state's."""
        where = source or "checkpoint"
        counts = [k for k in arrays
                  if k.startswith("opt_state/inner_state/")
                  and k.endswith("/0/count")]
        if len(counts) != 1:
            raise ValueError(f"{where}: no single optax Adam state "
                             f"({sorted(counts)})")
        prefix = counts[0][:-len("count")]
        decayed = prefix.split("/")[2] == "1"
        weight_decay = self.optimizer.param_groups[0]["weight_decay"]
        if decayed != bool(weight_decay):
            raise ValueError(
                f"{where} was written {'with' if decayed else 'without'} "
                "the L2 term, the optimizer has weight_decay="
                f"{weight_decay} (training.l2_reg_conv)")
        moments = {}
        for leaf, kind in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            head = f"{prefix}{leaf}/"
            moments[kind] = from_flax_flat(
                {"params/" + k[len(head):]: v for k, v in arrays.items()
                 if k.startswith(head)})
        count = int(arrays[counts[0]])
        self.step = int(arrays.get("step", count))
        self._set_moments(moments, count)
        self.with_learning_rate(
            float(arrays["opt_state/hyperparams/learning_rate"]))

    def _set_moments(self, moments: Dict[str, Dict[str, torch.Tensor]],
                     count: int) -> None:
        """``moments[kind][parameter name]`` into Adam's state, each
        on its parameter's device and in its memory format."""
        names = {n for n, _ in self.model.named_parameters()}
        for kind, values in moments.items():
            if set(values) != names:
                raise ValueError(f"{kind}: the checkpoint's parameters "
                                 f"{sorted(set(values) ^ names)} differ "
                                 "from the model's")
        for name, p in self.model.named_parameters():
            st = self.optimizer.state[p]
            for kind, values in moments.items():
                # empty_like keeps the parameter's device and memory format
                st[kind] = torch.empty_like(p).copy_(values[name])
            st["step"] = torch.tensor(float(count))
