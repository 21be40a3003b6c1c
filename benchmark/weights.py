"""Seeded weights of a configuration's reference model, and the flat
checkpoint layout the served program restores.

:func:`make_folds` fills one reference model per fold on the device from
``--seed``, in a few large generator calls: a normal draw shared by the
folds and one of each fold's own, mixed so that the folds agree as
trained folds of one ensemble do, then scaled leaf by leaf (conv and
dense weights by ``1 / sqrt(fan_in)``, biases by 0.05, BatchNorm scale
``1 + 0.1 n`` and shift ``0.1 n``, its mean ``0.1 n`` and variance
``exp(0.1 n)``, a leaf with no fan-in by the reference's ``FANLESS``),
then by the reference module's ``seed_conventions``. Statistics
calibrated to each layer's batch would make a random network chaotic
(bf16 rounding then moves a probability by 0.08); these keep it steady
under rounding, as a trained network is. Last, each fold's 1x1 head
(the reference's ``HEAD``) is scaled so that its logits have mean 0 and
standard deviation 1 over calibration images.

:func:`flat_arrays` writes a model's state as the flat
``params/...`` / ``batch_stats/...`` arrays of ``best.npz``: a conv
kernel HWIO (OIHW transposed), a module named ``Dense*`` [in, out] (a
1x1 conv there too), BatchNorm ``scale``, ``bias``, ``mean``, ``var``,
and any other module's parameters under their own names.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from benchmark import reference
from benchmark.reference import serve as ref_serve

#: how far a fold's weights depart from the folds' shared draw
FOLD_SPREAD = 0.5


def _fan_in(m: nn.Module) -> int:
    return int(np.prod(m.weight.shape[1:]))


def _generator(device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(
        (seed * 1_000_003 + stream) % (1 << 63))


@torch.no_grad()
def make_folds(cfg: dict, folds: int, seed: int, calib_u8: torch.Tensor,
               residual_scale: float = 1.0) -> List[nn.Module]:
    """``folds`` fp32 reference models on ``calib_u8``'s device, in eval
    mode; each head is scaled so that each logit channel has mean 0 and
    standard deviation 1 over the calibration images ``calib_u8``
    [B, 101, 101]. ``residual_scale`` multiplies the scale of the last
    BatchNorm of every residual branch (a training run's start: see
    ``kinds/fit.py``). The model is the configuration's reference
    (:func:`reference.for_config`)."""
    ref = reference.for_config(cfg)
    device = calib_u8.device
    with torch.device("meta"):
        template = ref.build(cfg)
    total = sum(t.numel() for t in _leaves(template))
    shared = torch.randn(total, generator=_generator(device, seed, 0),
                         device=device)
    models = []
    for k in range(folds):
        flat = shared + FOLD_SPREAD * torch.randn(
            total, generator=_generator(device, seed, k + 1), device=device)
        flat /= (1 + FOLD_SPREAD ** 2) ** 0.5
        model = ref.build_empty(cfg, device)
        off = 0
        for m in model.modules():
            for leaf, t in _own_leaves(m):
                v = flat[off:off + t.numel()].view_as(t)
                off += t.numel()
                if isinstance(m, nn.BatchNorm2d):
                    v = {"weight": 1 + 0.1 * v, "bias": 0.1 * v,
                         "running_mean": 0.1 * v,
                         "running_var": torch.exp(0.1 * v)}[leaf]
                elif leaf == "bias":
                    v = 0.05 * v
                elif leaf == "weight":
                    v = v / _fan_in(m) ** 0.5
                else:
                    mean, std = ref.FANLESS[leaf]
                    v = mean + std * v
                t.copy_(v)
            if isinstance(m, nn.BatchNorm2d):
                m.num_batches_tracked.zero_()
        ref.seed_conventions(model, residual_scale)
        model.eval()
        with exact_fp32():
            logits = model(ref_serve.preprocess(calib_u8))
        mean, std = logits.mean((0, 2, 3)), logits.std((0, 2, 3))
        head = model.get_submodule(ref.HEAD)
        head.weight /= std[:, None, None, None]
        head.bias.sub_(mean).div_(std)
        models.append(model)
    return models


def _own_leaves(m: nn.Module):
    """A module's own parameters and BatchNorm statistics, by name."""
    out = list(m.named_parameters(recurse=False))
    if isinstance(m, nn.BatchNorm2d):
        out += [("running_mean", m.running_mean),
                ("running_var", m.running_var)]
    return out


def _leaves(model: nn.Module):
    return [t for m in model.modules() for _, t in _own_leaves(m)]


class exact_fp32:
    """Within: no TF32 in cuDNN convs or in matrix products; the
    settings before are put back on exit."""

    def __enter__(self):
        self._prev = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self._prev
        return False


def flat_arrays(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's state under the flat checkpoint keys, fp32 numpy."""
    out: Dict[str, np.ndarray] = {}

    def arr(t):
        # transposed where the model lies, then one copy to the host
        return t.detach().float().contiguous().cpu().numpy()

    for name, m in model.named_modules():
        scope = name.replace(".", "/")
        if isinstance(m, nn.BatchNorm2d):
            out[f"params/{scope}/scale"] = arr(m.weight)
            out[f"params/{scope}/bias"] = arr(m.bias)
            out[f"batch_stats/{scope}/mean"] = arr(m.running_mean)
            out[f"batch_stats/{scope}/var"] = arr(m.running_var)
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            w = m.weight
            if name.rsplit(".", 1)[-1].startswith("Dense"):
                kernel = w.reshape(w.shape[0], -1).t()
            else:
                kernel = w.permute(2, 3, 1, 0)
            out[f"params/{scope}/kernel"] = arr(kernel)
            if m.bias is not None:
                out[f"params/{scope}/bias"] = arr(m.bias)
        else:
            for leaf, p in m.named_parameters(recurse=False):
                out[f"params/{scope}/{leaf}"] = arr(p)
    return out


def write_folds(models: List[nn.Module], experiment_dir: str) -> List[str]:
    """``<experiment_dir>/checkpoints/network_fold_<k>/best.npz``."""
    paths = []
    for k, model in enumerate(models):
        d = os.path.join(experiment_dir, "checkpoints", f"network_fold_{k}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "best.npz")
        with open(path, "wb") as f:
            np.savez(f, **flat_arrays(model))
        paths.append(path)
    return paths
