"""The operations and bytes of each hand-kernel launch, and the H100's
peak rates: the one source of both for ``train/cost_analysis.py``
(``FlopCounterMode`` and a dispatch mode see every torch op but not the
work inside a ctypes launch) and for ``chip_smoke.py``'s bounds. Each
kernel's wrapper calls :func:`record` where it launches: each input
read once, each output written once; a conv's 2 M N K, the sort's
compare-exchanges, the preprocess's six fp32 operations a pixel, the
quantizer's one a value; the rate its operations run at; the shape it
ran at. Nothing is kept unless a :func:`recording` is open."""
from __future__ import annotations

import contextlib
from typing import Iterable, List, NamedTuple, Tuple

#: H100 SXM: device memory, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM: fp32 outside the tensor cores, operations/s
FP32_FLOPS = 67e12
#: H100 SXM: bf16 tensor cores, dense
BF16_DENSE_FLOPS = 989e12
#: H100 SXM: int8 tensor cores, dense
INT8_DENSE_OPS = 1979e12


class Cost(NamedTuple):
    """One launch: its kernel, operations, bytes moved, the rate its
    operations run at (operations/s) and the shape it ran at."""
    kernel: str
    operations: int
    nbytes: int
    ops_per_s: float
    shape: Tuple[int, ...]


_open: List[List[Cost]] = []


def record(kernel: str, operations: int, nbytes: int, ops_per_s: float,
           shape: Iterable[int]) -> None:
    for launches in _open:
        launches.append(Cost(kernel, int(operations), int(nbytes),
                             ops_per_s, tuple(int(s) for s in shape)))


@contextlib.contextmanager
def recording():
    """Within: every launch's :class:`Cost` appended to the list it
    yields."""
    launches: List[Cost] = []
    _open.append(launches)
    try:
        yield launches
    finally:
        _open.remove(launches)


def bound_ms(nbytes: float, operations: float, ops_per_s: float
             ) -> Tuple[float, str]:
    """(the least ms the card could take, "bytes" or "operations"): the
    larger of ``nbytes`` at the memory rate and ``operations`` at
    ``ops_per_s``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, operations / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def launches_bound_ms(launches: Iterable[Cost]) -> Tuple[float, str]:
    """:func:`bound_ms` of recorded launches together: their bytes
    summed at the memory rate, their operations each at its rate."""
    launches = list(launches)
    if not launches:
        raise ValueError("no launch recorded")
    nbytes = sum(c.nbytes for c in launches)
    seconds = sum(c.operations / c.ops_per_s for c in launches)
    return bound_ms(nbytes, seconds, 1.0)
