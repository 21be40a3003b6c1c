"""Weights across the two packages: flat flax checkpoint <-> torch modules.

The JAX package saves ``{"params": ..., "batch_stats": ...}`` as a flat
npz keyed by '/'-joined flax paths (``core/experiment.py``). The port's
modules copy the flax scope names, so a key maps to a state_dict key by
joining the same names with '.', and each leaf converts as follows:

- conv ``kernel`` HWIO -> ``weight`` OIHW; a transposed conv's
  (``ConvTranspose_*``) [kh, kw, in, out] -> ``nn.ConvTranspose2d``'s
  [in, out, kh, kw], unflipped (``blocks.DeconvConvBnRelu`` flips it);
- a PReLU's scalar ``prelu_alpha`` -> the module's 0-d ``prelu_alpha``;
- ``Dense`` ``kernel`` [in, out] -> ``Linear`` ``weight`` [out, in] (the
  spatial SE ``Dense`` is a 1x1 conv: [out, in, 1, 1]);
- ``bias`` -> ``bias``;
- BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` ->
  ``weight``/``bias``/``running_mean``/``running_var`` (eps 1e-5 on both
  sides; ``num_batches_tracked`` is set to 0).

``to_flax_flat`` is the exact inverse, so either package serves the
other's ``best.npz``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch
from torch import nn

_BN_LEAVES = {("params", "scale"): "weight", ("params", "bias"): "bias",
              ("batch_stats", "mean"): "running_mean",
              ("batch_stats", "var"): "running_var"}


def _is_bn_scope(arrays: Dict[str, np.ndarray], scope: str) -> bool:
    return f"params/{scope}/scale" in arrays


def from_flax_flat(arrays: Dict[str, np.ndarray]) -> "OrderedDict[str, torch.Tensor]":
    """Flat ``params/...``/``batch_stats/...`` arrays -> a state_dict for
    the port's module of the same architecture."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key in sorted(arrays):
        collection, *path, leaf = key.split("/")
        scope = "/".join(path)
        name = ".".join(path)
        value = np.asarray(arrays[key], dtype=np.float32)
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unexpected checkpoint collection in {key!r}")
        if _is_bn_scope(arrays, scope):
            sd[f"{name}.{_BN_LEAVES[(collection, leaf)]}"] = torch.tensor(value)
            if leaf == "var":
                sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
        elif leaf == "kernel" and value.ndim == 4:
            axes = ((2, 3, 0, 1) if path[-1].startswith("ConvTranspose")
                    else (3, 2, 0, 1))
            sd[f"{name}.weight"] = torch.tensor(value.transpose(axes))
        elif leaf == "kernel" and value.ndim == 2:
            w = value.T
            if "SpatialSELayer" in scope:
                w = w[:, :, None, None]
            sd[f"{name}.weight"] = torch.tensor(w)
        elif leaf == "bias":
            sd[f"{name}.bias"] = torch.tensor(value)
        elif leaf == "prelu_alpha" and value.ndim == 0:
            sd[f"{name}.prelu_alpha"] = torch.tensor(value)
        else:
            raise KeyError(f"unexpected checkpoint leaf {key!r}")
    return sd


def load_flax_flat(model: nn.Module, arrays: Dict[str, np.ndarray]) -> nn.Module:
    """Load flat flax arrays into ``model`` (strict: every key on both
    sides must match)."""
    sd = from_flax_flat(arrays)
    target = model.state_dict()
    for k, v in sd.items():
        if k in target and target[k].shape != v.shape:
            raise ValueError(f"checkpoint {k}: shape {tuple(v.shape)} vs "
                             f"model {tuple(target[k].shape)}")
    model.load_state_dict(sd, strict=True)
    return model


def to_flax_flat(model: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of :func:`from_flax_flat`: fp32 numpy arrays under the
    JAX package's flat keys."""
    out: Dict[str, np.ndarray] = {}

    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", torch.float32).numpy().copy()

    for name, m in model.named_modules():
        scope = name.replace(".", "/")
        if isinstance(m, nn.BatchNorm2d):
            out[f"params/{scope}/scale"] = arr(m.weight)
            out[f"params/{scope}/bias"] = arr(m.bias)
            out[f"batch_stats/{scope}/mean"] = arr(m.running_mean)
            out[f"batch_stats/{scope}/var"] = arr(m.running_var)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = arr(m.weight)
            if isinstance(m, nn.ConvTranspose2d):
                kernel = np.ascontiguousarray(w.transpose(2, 3, 0, 1))
            elif name.rsplit(".", 1)[-1].startswith("Dense"):
                kernel = np.ascontiguousarray(w.reshape(w.shape[0], -1).T)
            else:
                kernel = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
            out[f"params/{scope}/kernel"] = kernel
            if m.bias is not None:
                out[f"params/{scope}/bias"] = arr(m.bias)
        if isinstance(getattr(m, "prelu_alpha", None), nn.Parameter):
            out[f"params/{scope}/prelu_alpha"] = arr(m.prelu_alpha)
    return out
