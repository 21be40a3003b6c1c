"""Wrapper of the bitonic sort CUDA kernel (``csrc/bitonic_sort.cu``) and
the differentiable sort of the per-image Lovász hinge built on it.

Counterpart of ``salt_tpu/ops/pallas_sort.py``: ``sort_desc_pallas``
(:87-121) is :func:`sort_desc`, the custom VJP ``sort_desc_with_labels``
(:124-163) is :class:`SortDescWithLabels`, ``lovasz_hinge_flat_pallas``
(:169-184) is :func:`lovasz_hinge_flat_kernel`.

:func:`sort_desc` takes fp32 keys and an int32 payload [B, P] with P a
power of two in [128, 32,768], on any device, and raises on anything else
before a launch.

- A tensor on the CPU takes the plain version, ``ops.bitonic``.
- A CUDA tensor runs the kernel's plan on the current stream or raises;
  there is no fallback. It must be contiguous and 16-byte aligned.
- The plan (:func:`sort_plan`) splits the network into launches: one
  sorts each chunk of a row per block; then, for each longer merge, one
  strided pass does the stages whose partners lie chunks apart and one
  chunk launch the rest. The chunk is ``CHUNK`` while those blocks fit
  one to an SM, else ``MAX_CHUNK`` (:func:`chunk_for`): at P = 32,768, 7
  launches up to 33 rows on an H100's 132 SMs, 5 above; 1 at P <=
  ``CHUNK``. ``ops.bitonic.run_plan`` executes the same plans on the
  CPU.
- ``launches`` counts the calls that launched the kernel's plan on the
  card, one per call, and nothing else; ``device_launches`` counts the
  kernel launches those calls issued, the plan's length per call.

Both give the same permutation, bit for bit: equal keys never swap.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from salt_tpu_torch.losses.lovasz import lovasz_grad, weigh_errors_with_size
from salt_tpu_torch.ops import build, costs
from salt_tpu_torch.ops.bitonic import (DST_OUTPUT, DST_SCRATCH, OP_CHUNK,
                                        OP_STRIDED, SRC_INPUT, SRC_SCRATCH,
                                        Launch, bitonic_sort_desc)

#: the longest row: its uint16 index would take 65,536, but the plan
#: would then need 9 launches at ``CHUNK``
MAX_LENGTH = 32768
#: the two chunks a plan takes, elements of a row that one block sorts
#: (:func:`chunk_for`); the kernel's shared memory holds ``MAX_CHUNK``
CHUNK = 4096
MAX_CHUNK = 8192
#: the most launches a plan may have (7 at most, at ``CHUNK``)
MAX_LAUNCHES = 8
#: the name prefix of every kernel of the plan, for the profiler
KERNEL_PREFIX = "bitonic_sort_"
_MAX_ROWS = 65535                 # the grid's y dimension

#: calls that launched the kernel's plan since the last reset (set it to
#: 0 to reset)
launches = 0
#: kernel launches those calls issued
device_launches = 0

_LABEL_SHIFT = 20
_INDEX_MASK = (1 << _LABEL_SHIFT) - 1


def kernel_length_ok(p: int) -> bool:
    """The row lengths the kernel sorts (the geometry rule of the
    per-image Lovász hinge, ``salt_tpu/losses/lovasz.py:110``)."""
    return 128 <= p <= MAX_LENGTH and p & (p - 1) == 0


def chunk_for(rows: int, p: int, sm_count: int) -> int:
    """The chunk :func:`sort_desc` plans [rows, P] with: ``CHUNK`` while
    the rows x P / ``CHUNK`` blocks of its chunk launches fit one to
    each of the card's ``sm_count`` SMs, else ``MAX_CHUNK``, half the
    blocks in two launches fewer at P = 32,768 (where the smaller
    chunk's blocks would share SMs; ``tools/sort_probe.py`` times both
    chunks)."""
    return CHUNK if rows * max(p // CHUNK, 1) <= sm_count else MAX_CHUNK


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def card_plan(rows: int, p: int, device: torch.device) -> Tuple[Launch, ...]:
    """The plan :func:`sort_desc` runs for [rows, P] on a CUDA
    ``device``."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return sort_plan(p, chunk_for(rows, p, _sm_count(index)))


@functools.lru_cache(maxsize=None)
def sort_plan(p: int, chunk: int) -> Tuple[Launch, ...]:
    """The kernel's launches for rows of ``p``: the chunk sort (every
    stage with k_exp <= log2 chunk), then, for each k_exp above it, a
    strided pass (j_exp >= log2 chunk) and a chunk merge (j_exp below);
    the last launch writes the outputs. A chunk launch's thread holds 16
    consecutive elements (fewer at chunks under 512, so that a block is
    one warp at least); its shared memory is two buffers of (fp32 key,
    uint16 index), 6 B a pair plus padding, used only where a stride
    reaches past a warp."""
    if not kernel_length_ok(p):
        raise ValueError(f"sort kernel takes P a power of two in [128, "
                         f"{MAX_LENGTH}], got {p}")
    if chunk not in (CHUNK, MAX_CHUNK):
        raise ValueError(f"sort kernel chunk: {CHUNK} or {MAX_CHUNK}, got "
                         f"{chunk}")
    n = p.bit_length() - 1
    c = min(chunk, p)
    lc = c.bit_length() - 1
    le = 4 if c >= 512 else lc - 5
    smem = 2 * (c + c // 32) * 6 if lc > le + 5 else 0

    def chunk_launch(k_lo, k_hi, src):
        dst = DST_OUTPUT if k_hi == n else DST_SCRATCH
        return Launch(OP_CHUNK, n, k_lo, k_hi, lc - 1, 0, lc, le, src, dst,
                      c >> le, p // c, smem)

    plan = [chunk_launch(1, lc, SRC_INPUT)]
    for k_exp in range(lc + 1, n + 1):
        lg = k_exp - lc                        # a thread's elements, log2
        threads = min(256, p >> lg)
        plan.append(Launch(OP_STRIDED, n, k_exp, k_exp, k_exp - 1, lc, lc,
                           lg, SRC_SCRATCH, DST_SCRATCH, threads,
                           (p >> lg) // threads, 0))
        plan.append(chunk_launch(k_exp, k_exp, SRC_SCRATCH))
    return tuple(plan)


@functools.lru_cache(maxsize=None)
def _plan_arg(p: int, chunk: int):
    """The plan as the C entry takes it: a flat int32 array (kept alive
    here) and its address."""
    plan = sort_plan(p, chunk)
    flat = (ctypes.c_int32 * (len(plan) * len(Launch._fields)))(
        *(v for launch in plan for v in launch))
    return flat, ctypes.addressof(flat), len(plan)


_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_void_p])


def sort_desc(keys: torch.Tensor, payload: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending sort of fp32 ``keys`` [B, P] along P, carrying the
    int32 ``payload`` [B, P]; by the CUDA kernel's plan for a CUDA
    tensor."""
    if keys.dtype != torch.float32:
        raise TypeError(f"sort kernel takes fp32 keys, got {keys.dtype}")
    if payload.dtype != torch.int32:
        raise TypeError(f"sort kernel takes an int32 payload, got "
                        f"{payload.dtype}")
    if keys.ndim != 2 or payload.shape != keys.shape:
        raise ValueError(f"sort kernel takes keys and payload [B, P] of one "
                         f"shape, got {tuple(keys.shape)} and "
                         f"{tuple(payload.shape)}")
    if not kernel_length_ok(keys.shape[1]):
        raise ValueError(f"sort kernel takes P a power of two in [128, "
                         f"{MAX_LENGTH}], got {keys.shape[1]}")
    if payload.device != keys.device:
        raise ValueError(f"keys on {keys.device}, payload on "
                         f"{payload.device}")
    if keys.device.type == "cpu":
        return bitonic_sort_desc(keys, payload)
    if keys.device.type != "cuda":
        raise ValueError(f"sort kernel: unsupported device {keys.device}")
    rows, p = keys.shape
    return launch_plan(keys, payload,
                       chunk_for(rows, p, _sm_count(keys.device.index)))


def launch_plan(keys: torch.Tensor, payload: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``sort_plan(P, chunk)`` on CUDA ``keys`` and ``payload`` of
    the types and shape :func:`sort_desc` checks: its launch at the
    chunk :func:`chunk_for` gives, and the probe's at either chunk."""
    global launches, device_launches
    if keys.device.type != "cuda":
        raise ValueError(f"sort kernel: unsupported device {keys.device}")
    if not (keys.is_contiguous() and payload.is_contiguous()):
        raise ValueError("sort kernel takes contiguous tensors")
    if keys.data_ptr() % 16 or payload.data_ptr() % 16:
        raise ValueError("sort kernel takes 16-byte aligned tensors")
    b, p = keys.shape
    if b > _MAX_ROWS:
        raise ValueError(f"sort kernel takes at most {_MAX_ROWS} rows, "
                         f"got {b}")
    _, plan_ptr, n_launches = _plan_arg(p, chunk)
    keys_out = torch.empty_like(keys)
    payload_out = torch.empty_like(payload)
    if b == 0:
        return keys_out, payload_out
    # the (fp32 key, uint16 index) pairs between launches
    scratch = (torch.empty(b * p * 6, dtype=torch.uint8, device=keys.device)
               if n_launches > 1 else None)
    scratch_keys = scratch.data_ptr() if scratch is not None else None
    scratch_index = scratch_keys + b * p * 4 if scratch is not None else None
    fn = build.function("bitonic_sort", "salt_bitonic_sort_desc", _ARGTYPES)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(keys.data_ptr(), payload.data_ptr(), keys_out.data_ptr(),
                payload_out.data_ptr(), scratch_keys, scratch_index, b,
                plan_ptr, n_launches, stream)
    if rc != 0:
        raise RuntimeError(f"sort kernel launch failed: cudaError {rc}")
    launches += 1
    device_launches += n_launches
    log_p = p.bit_length() - 1
    costs.record("bitonic_sort", log_p * (log_p + 1) // 2 * (b * p // 2),
                 b * p * 16, costs.FP32_FLOPS, keys.shape)
    return keys_out, payload_out


class SortDescWithLabels(torch.autograd.Function):
    """Differentiable descending sort of ``errors`` [B, P] carrying the
    binary ``labels`` along. The payload packs ``label << 20 | index``,
    so one sort gives both the sorted labels and the permutation; the
    gradient flows through the errors only and is the scatter of the
    incoming gradient back through the permutation (``_sort_bwd``,
    ``pallas_sort.py:156-163``: plain code there too, no kernel).

    Returns (sorted errors, sorted labels, permutation); the last two
    carry no gradient. ``forward`` / ``setup_context`` is the form
    ``torch.func`` transforms take, and :meth:`vmap` folds the mapped
    axis into the rows: [K, B, P] sorts as [K * B, P], one call of
    :func:`sort_desc` (the sort is per row, so this is exact)."""

    @staticmethod
    def forward(errors: torch.Tensor, labels: torch.Tensor):
        b, p = errors.shape
        iota = torch.arange(p, dtype=torch.int32, device=errors.device)
        packed = (labels.to(torch.int32) << _LABEL_SHIFT) | iota
        errors_sorted, packed_sorted = sort_desc(
            errors.to(torch.float32).contiguous(), packed.contiguous())
        labels_sorted = (packed_sorted >> _LABEL_SHIFT).to(torch.float32)
        perm = (packed_sorted & _INDEX_MASK).to(torch.int64)
        return errors_sorted, labels_sorted, perm

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, labels_sorted, perm = output
        ctx.save_for_backward(perm)
        ctx.mark_non_differentiable(labels_sorted, perm)

    @staticmethod
    def backward(ctx, g_errors_sorted, _g_labels_sorted, _g_perm):
        (perm,) = ctx.saved_tensors
        g = torch.zeros_like(g_errors_sorted)
        return g.scatter(-1, perm, g_errors_sorted), None

    @staticmethod
    def vmap(info, in_dims, errors, labels):
        k = info.batch_size
        errors = (errors.movedim(in_dims[0], 0) if in_dims[0] is not None
                  else errors.expand(k, *errors.shape))
        labels = (labels.movedim(in_dims[1], 0) if in_dims[1] is not None
                  else labels.expand(k, *labels.shape))
        b, p = errors.shape[1:]
        out = SortDescWithLabels.apply(errors.reshape(k * b, p),
                                       labels.reshape(k * b, p))
        return tuple(t.reshape(k, b, p) for t in out), (0, 0, 0)


def lovasz_hinge_flat_kernel(logits: torch.Tensor, labels: torch.Tensor,
                             size_weighted: bool = False) -> torch.Tensor:
    """Lovász hinge of each row of flat [B, P] logits and {0, 1} labels
    through :class:`SortDescWithLabels`; the per-row losses [B]."""
    labels = labels.to(torch.float32)
    signs = 2.0 * labels - 1.0
    errors = 1.0 - logits.to(torch.float32) * signs
    if size_weighted:
        errors = weigh_errors_with_size(labels, errors)
    errors_sorted, gt_sorted, _ = SortDescWithLabels.apply(errors, labels)
    grad = lovasz_grad(gt_sorted)
    return torch.sum(F.elu(errors_sorted) * grad, dim=-1)
