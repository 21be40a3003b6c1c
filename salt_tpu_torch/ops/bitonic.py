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

The kernel runs the same network as a *plan*, a short list of launches
(:class:`Launch`, built by ``sort_kernel.sort_plan``), each doing a run
of the network's stages over one chunk of a row per block or over groups
of elements at the chunk's stride. :func:`run_plan` executes a plan with
plain tensor code, each launch seeing only the elements its block or
thread would see, so the CPU tests can hold the decomposition against
the network.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Sequence, Tuple

import torch


def _exchange(kr, pr, desc):
    """The network's compare-exchange of the two slots of axis -2 (its
    partners), descending where ``desc``: swap on a strict < / >."""
    a_k, b_k = kr[..., 0, :], kr[..., 1, :]
    a_p, b_p = pr[..., 0, :], pr[..., 1, :]
    swap = torch.where(desc, a_k < b_k, a_k > b_k)
    return (torch.stack([torch.where(swap, b_k, a_k),
                         torch.where(swap, a_k, b_k)], dim=-2),
            torch.stack([torch.where(swap, b_p, a_p),
                         torch.where(swap, a_p, b_p)], dim=-2))


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
            r = torch.arange(rows, device=keys.device).reshape(rows, 1)
            desc = ((r * (2 * j)) & k) == 0                  # [rows, 1]
            keys, payload = _exchange(keys.reshape(*lead, rows, 2, j),
                                      payload.reshape(*lead, rows, 2, j),
                                      desc)
            keys = keys.reshape(*lead, p)
            payload = payload.reshape(*lead, p)
    return keys, payload


#: ``Launch.op``: a block sorts one chunk of a row through every planned
#: stage; or a thread holds the elements at the chunk's stride in one
#: 2^k-block and does the stages whose partners lie chunks apart
OP_CHUNK, OP_STRIDED = 0, 1
#: ``Launch.src``: the input keys with their row positions as the index,
#: or the scratch (key, index) pairs that the previous launch wrote
SRC_INPUT, SRC_SCRATCH = 0, 1
#: ``Launch.dst``: the scratch pairs, or the outputs (the keys, and the
#: payload gathered through the index)
DST_SCRATCH, DST_OUTPUT = 0, 1


class Launch(NamedTuple):
    """One launch of the sort kernel's plan. The C side reads these
    fields, in this order, as one row of int32 and derives nothing else.

    It does the network's stages (k_exp, j_exp) for k_exp from ``k_lo``
    to ``k_hi`` and, in each, j_exp from min(k_exp - 1, ``j_hi``) down to
    ``j_lo``, in the network's order. ``log_chunk`` is log2 of the chunk
    (``OP_CHUNK``: the elements of a block; ``OP_STRIDED``: the stride
    between a thread's elements); ``log_per_thread`` is log2 of the
    elements a thread holds in registers; ``blocks_per_row`` × the rows
    and ``threads`` are the grid; ``smem_bytes`` its dynamic shared
    memory."""
    op: int
    log_length: int
    k_lo: int
    k_hi: int
    j_hi: int
    j_lo: int
    log_chunk: int
    log_per_thread: int
    src: int
    dst: int
    threads: int
    blocks_per_row: int
    smem_bytes: int


def launch_stages(launch: Launch) -> Iterator[Tuple[int, int]]:
    """The (k_exp, j_exp) stages of one launch, in the order it runs
    them."""
    for k_exp in range(launch.k_lo, launch.k_hi + 1):
        for j_exp in range(min(k_exp - 1, launch.j_hi), launch.j_lo - 1, -1):
            yield k_exp, j_exp


def _run_chunk(keys, index, launch):
    """An ``OP_CHUNK`` launch: each chunk of each row alone, the
    direction of a stage from the position in the row."""
    b, p = keys.shape
    c = 1 << launch.log_chunk
    n = p // c
    if launch.threads << launch.log_per_thread != c or \
            launch.blocks_per_row * c != p:
        raise ValueError(f"chunk launch geometry {launch}")
    for k_exp, j_exp in launch_stages(launch):
        if j_exp >= launch.log_chunk:
            raise ValueError(f"stage ({k_exp}, {j_exp}) reaches outside "
                             f"a chunk of {c}")
        j = 1 << j_exp
        shape = (b, n, c // (2 * j), 2, j)
        chunk = torch.arange(n, device=keys.device).reshape(n, 1, 1)
        pair = torch.arange(c // (2 * j), device=keys.device).reshape(1, -1, 1)
        desc = (((chunk * c + pair * 2 * j) >> k_exp) & 1) == 0
        keys, index = _exchange(keys.reshape(shape), index.reshape(shape),
                                desc)
    return keys.reshape(b, p), index.reshape(b, p)


def _run_strided(keys, index, launch):
    """An ``OP_STRIDED`` launch: each thread's elements, one per chunk
    of a 2^k-block at one offset in the chunk, alone."""
    b, p = keys.shape
    c, g = 1 << launch.log_chunk, 1 << launch.log_per_thread
    if launch.k_lo != launch.k_hi or \
            launch.log_chunk + launch.log_per_thread != launch.k_lo or \
            launch.threads * launch.blocks_per_row * g != p:
        raise ValueError(f"strided launch geometry {launch}")
    n = p // (g * c)                                   # 2^k-blocks per row
    for k_exp, j_exp in launch_stages(launch):
        if not launch.log_chunk <= j_exp < launch.k_lo:
            raise ValueError(f"stage ({k_exp}, {j_exp}) is not between a "
                             f"thread's elements")
        j = 1 << (j_exp - launch.log_chunk)
        # [block, m, offset] with m = (pair, slot, column): partners are
        # the slots, j chunks apart
        shape = (b, n, g // (2 * j), 2, j * c)
        # bit k_exp of the position block * 2^k_exp + m * c + offset
        desc = (torch.arange(n, device=keys.device).reshape(n, 1, 1) & 1) == 0
        keys, index = _exchange(keys.reshape(shape), index.reshape(shape),
                                desc)
    return keys.reshape(b, p), index.reshape(b, p)


def run_plan(keys: torch.Tensor, payload: torch.Tensor,
             plan: Sequence[Launch]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Execute the sort kernel's ``plan`` on [B, P] ``keys`` and
    ``payload`` with plain tensor code, as the kernel does: sort (key,
    row index) pairs, launch after launch, then gather the payload
    through the index. Raises where a launch would need an element its
    block or thread does not hold, or reads what no launch wrote."""
    b, p = keys.shape
    pairs = out = None
    for launch in plan:
        if out is not None:
            raise ValueError("a launch after the one that wrote the output")
        if (1 << launch.log_length) != p:
            raise ValueError(f"plan for rows of {1 << launch.log_length}, "
                             f"keys of {p}")
        if launch.src == SRC_INPUT:
            pairs = (keys, torch.arange(p, device=keys.device).expand(b, p))
        elif pairs is None:
            raise ValueError("the first launch reads the scratch")
        run = _run_chunk if launch.op == OP_CHUNK else _run_strided
        pairs = run(*pairs, launch)
        if launch.dst == DST_OUTPUT:
            out = pairs[0], payload.gather(1, pairs[1])
    if out is None:
        raise ValueError("no launch writes the output")
    return out
