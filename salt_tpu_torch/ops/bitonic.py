"""Bitonic descending sort with payload, as plain torch (counterpart of
``salt_tpu/ops/bitonic.py`` :21-63).

The same compare-exchange network as the JAX package, written as
reshapes and selects: at stage (k, j) element i exchanges with i ^ j;
with the reshape [P] -> [P/(2j), 2, j] the partners are the two slots of
axis 1, and the block's direction is descending where
``(r * 2j) & k == 0`` for row r. ``swap = a < b`` in a descending block
and ``a > b`` in an ascending one, so **equal keys never swap** and a
tie keeps the order the network gives it.

This is the plain version of the CUDA kernel in ``ops/sort_kernel.py``:
the CPU tests hold it against the JAX network bit for bit, the kernel's
wrapper takes it for a CPU tensor, and ``chip_smoke.py`` holds the
kernel against it on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def bitonic_sort_desc(keys: torch.Tensor, payload: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending sort of ``keys`` along the last axis, carrying
    ``payload`` (same shape). The last axis must be a power of two."""
    p = keys.shape[-1]
    n = p.bit_length() - 1
    if p < 1 or (1 << n) != p:
        raise ValueError(f"length {p} is not a power of two")
    if payload.shape != keys.shape:
        raise ValueError(f"payload {tuple(payload.shape)} vs keys "
                         f"{tuple(keys.shape)}")
    lead = keys.shape[:-1]
    for k_exp in range(1, n + 1):
        k = 1 << k_exp
        for j_exp in range(k_exp - 1, -1, -1):
            j = 1 << j_exp
            rows = p // (2 * j)
            kr = keys.reshape(*lead, rows, 2, j)
            pr = payload.reshape(*lead, rows, 2, j)
            a_k, b_k = kr[..., 0, :], kr[..., 1, :]
            a_p, b_p = pr[..., 0, :], pr[..., 1, :]
            r = torch.arange(rows, device=keys.device).reshape(rows, 1)
            desc = ((r * (2 * j)) & k) == 0                  # [rows, 1]
            swap = torch.where(desc, a_k < b_k, a_k > b_k)
            keys = torch.stack([torch.where(swap, b_k, a_k),
                                torch.where(swap, a_k, b_k)],
                               dim=-2).reshape(*lead, p)
            payload = torch.stack([torch.where(swap, b_p, a_p),
                                   torch.where(swap, a_p, b_p)],
                                  dim=-2).reshape(*lead, p)
    return keys, payload
