"""Flat-npz checkpoints, the format both packages read and write.

The checkpoint part of ``salt_tpu/core/experiment.py`` (``save_params`` /
``load_params``): one ``np.savez`` archive whose keys are the '/'-joined
flax paths of the model variables, ``params/<module path>/<leaf>`` and
``batch_stats/<module path>/<leaf>`` (``_path_str`` of the JAX package
joins the same names). ``models.convert`` maps these keys to and from
the port's modules, so each package serves the other's ``best.npz``.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Dict

import numpy as np


def save_flat_npz(path: str, arrays: Dict[str, np.ndarray]) -> str:
    """Write ``arrays`` atomically (temp file + ``os.replace``), creating
    the parent directory; an interrupted save leaves any previous file
    intact."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=parent or ".",
                               prefix=os.path.basename(path) + ".tmp.",
                               suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    return path


def load_flat_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def checkpoint_path(experiment_dir: str, name: str = "network",
                    tag: str = "best") -> str:
    """``<dir>/checkpoints/<name>/<tag>.npz`` (the JAX ``Experiment``
    layout; CV folds are ``network_fold_<i>``)."""
    return os.path.join(experiment_dir, "checkpoints", name, f"{tag}.npz")
