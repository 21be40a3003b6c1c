"""Misc host-side utilities (own copy of ``salt_tpu/utils.py``):
API-parity helpers for reference common_blocks/utils.py functions not
covered by dedicated modules. numpy and PIL, and torch's seed in
:func:`set_seed`.
"""
from __future__ import annotations

import random
from typing import List, Sequence

import numpy as np
import torch


def sigmoid(x):
    """(reference: utils.py:173-174)."""
    return 1.0 / (1.0 + np.exp(-np.asarray(x)))


def softmax(x, theta: float = 1.0, axis=None):
    """Numerically stable softmax over numpy arrays
    (reference: utils.py:177-219)."""
    y = np.atleast_2d(np.asarray(x, dtype=np.float64))
    if axis is None:
        axis = next(j[0] for j in enumerate(y.shape) if j[1] > 1)
    y = y * float(theta)
    y = y - np.expand_dims(np.max(y, axis=axis), axis)
    y = np.exp(y)
    p = y / np.expand_dims(np.sum(y, axis=axis), axis)
    if np.ndim(x) == 1:
        p = p.flatten()
    return p


def from_pil(*images):
    """(reference: utils.py:222-227)."""
    arrays = [np.array(im) for im in images]
    return arrays[0] if len(arrays) == 1 else arrays


def to_pil(*images):
    """(reference: utils.py:230-235)."""
    from PIL import Image
    pils = [Image.fromarray(np.asarray(im).astype(np.uint8))
            for im in images]
    return pils[0] if len(pils) == 1 else pils


def get_list_of_image_predictions(batch_predictions) -> List:
    """Flatten batched predictions into a per-image list
    (reference: utils.py:316-320)."""
    out = []
    for batch in batch_predictions:
        out.extend(list(batch))
    return out


def set_seed(seed: int) -> None:
    """RNG seeding (reference: utils.py:323-328): ``random``, numpy and
    torch's default generators (every device's). The port's train steps
    draw from generators they seed themselves and need no global seed."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def plot_list(images: Sequence[np.ndarray] = (),
              labels: Sequence[np.ndarray] = (), vmin: float = 0.0,
              vmax: float = 1.0, save_to: str = ""):
    """Side-by-side image/label plotting (reference: utils.py:392-405);
    optionally saves instead of showing (headless environments)."""
    import matplotlib
    if save_to:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    n = len(images) + len(labels)
    fig, axs = plt.subplots(1, max(n, 1), figsize=(16, 12), squeeze=False)
    axs = axs[0]
    for i, image in enumerate(images):
        axs[i].imshow(image, vmin=vmin, vmax=vmax)
        axs[i].set_xticks([]); axs[i].set_yticks([])
    for j, label in enumerate(labels):
        axs[len(images) + j].imshow(label, cmap="nipy_spectral")
        axs[len(images) + j].set_xticks([])
        axs[len(images) + j].set_yticks([])
    if save_to:
        fig.savefig(save_to, bbox_inches="tight")
        plt.close(fig)
    else:
        plt.show()
    return fig
