"""Host input pipeline: batch iteration and a device feed one batch ahead
(counterpart of ``salt_tpu/data/pipeline.py``).

Batches are uint8 slices of the packed arrays. ``batch_indices`` is the
JAX package's, so a ``RandomState`` seed gives the same batch order in
both packages. ``prefetch_to_device`` keeps the next batch's host-to-
device copy in flight while the current step runs; ``to_device`` makes
the copy from pinned host memory with ``non_blocking=True`` on a CUDA
device, so it overlaps the step's kernels.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator, Tuple

import numpy as np
import torch


def batch_indices(n: int, batch_size: int, shuffle: bool,
                  rng: np.random.RandomState,
                  drop_last: bool = True) -> Iterator[np.ndarray]:
    """Index batches over a packed dataset (training drops the ragged
    tail)."""
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    for lo in _starts(n, batch_size, drop_last):
        yield idx[lo:lo + batch_size]


def batch_count(n: int, batch_size: int, drop_last: bool = True) -> int:
    """How many batches :func:`batch_indices` yields."""
    return len(_starts(n, batch_size, drop_last))


def _starts(n: int, batch_size: int, drop_last: bool) -> range:
    end = n - batch_size + 1 if drop_last else n
    return range(0, max(end, 0), batch_size)


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array on ``device``: pinned and asynchronous to a CUDA
    device (the caching host allocator keeps the pinned buffer alive
    until the copy is done), a plain wrap on the CPU."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host


def prefetch_to_device(host_batches: Iterable[Tuple[np.ndarray, ...]],
                       put: Callable[..., Tuple], depth: int = 1
                       ) -> Iterator[Tuple]:
    """Keep ``depth`` device batches in flight ahead of the consumer."""
    queue: deque = deque()
    it = iter(host_batches)
    for batch in it:
        queue.append(put(*batch))
        if len(queue) >= depth:
            break
    while queue:
        out = queue.popleft()
        nxt = next(it, None)
        if nxt is not None:
            queue.append(put(*nxt))
        yield out
