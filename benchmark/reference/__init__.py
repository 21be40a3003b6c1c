"""The benchmark's plain float32 references: nothing of the program.

``serve``, ``train`` and ``quant`` are shared by every configuration.
The model itself is the configuration's own: its file names the module
with ``"reference": "<module>"`` (``benchmark/reference/<module>.py``;
``unet`` where the key is absent), found by name as the kinds and the
metrics are. A model's module provides:

- ``build(cfg)``: the configuration's model in fp32, in eval mode.
  ``forward(x, conv=None)`` maps [B, 3, 128, 128] to logits
  [B, num_classes, 128, 128]. Module names follow the program's flat
  checkpoint layout (``benchmark/weights.py::flat_arrays`` writes it from
  them). ``conv``, with ``F.conv2d``'s signature, replaces the
  convolution exactly at the sites where the program hands its conv
  callable, and at none where the program hands none.
- ``build_empty(cfg, device)``: ``build`` with uninitialised storage on
  ``device`` (the caller fills every leaf).
- ``HEAD``: the name of the 1x1 conv with bias that ends the network;
  ``weights.make_folds`` scales it so that each logit channel has mean 0
  and standard deviation 1 over calibration images.
- ``seed_conventions(model, residual_scale)``: the family's own scaling
  of the seeded weights, applied after ``weights.make_folds``'s generic
  draw and before the head's calibration. ``residual_scale`` multiplies
  the scale of the last BatchNorm of every residual branch.
- ``FANLESS``: for each leaf name with no fan-in (not a ``weight``, a
  ``bias`` or a BatchNorm leaf: a PReLU's 0-d slope), ``(mean, std)``,
  the leaf seeded as ``mean + std * n`` from its standard normal draw.
"""
from __future__ import annotations

import importlib

#: the model reference of a configuration that names none
DEFAULT = "unet"


def for_config(cfg: dict):
    """The module of ``cfg``'s model reference."""
    name = cfg.get("reference", DEFAULT)
    if not name.isidentifier():
        raise ValueError(f"reference {name!r} is not a module name")
    return importlib.import_module(f"{__name__}.{name}")
