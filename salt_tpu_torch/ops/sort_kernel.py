"""Wrapper of the bitonic sort CUDA kernel (``csrc/bitonic_sort.cu``) and
the differentiable sort of the per-image Lovász hinge built on it.

Counterpart of ``salt_tpu/ops/pallas_sort.py``: ``sort_desc_pallas``
(:87-121) is :func:`sort_desc`, the custom VJP ``sort_desc_with_labels``
(:124-163) is :class:`SortDescWithLabels`, ``lovasz_hinge_flat_pallas``
(:169-184) is :func:`lovasz_hinge_flat_kernel`.

:func:`sort_desc` takes fp32 keys and an int32 payload [B, P] with P a
power of two, a multiple of 128 and at most 32,768 (the kernel's shared
memory), on any device, and raises on anything else before a launch.

- A tensor on the CPU takes the plain version, ``ops.bitonic``.
- A CUDA tensor launches the kernel on the current stream or raises;
  there is no fallback. It must be contiguous.
- ``launches`` counts kernel launches, and nothing else.

Both give the same permutation, bit for bit: equal keys never swap.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from salt_tpu_torch.losses.lovasz import lovasz_grad, weigh_errors_with_size
from salt_tpu_torch.ops import build
from salt_tpu_torch.ops.bitonic import bitonic_sort_desc

#: the longest row the kernel sorts: (key, uint16 index) pairs of a row
#: fill 192 KiB of the 227 KB of shared memory a block may use
MAX_LENGTH = 32768

#: kernel launches since the last reset (set it to 0 to reset)
launches = 0

_LABEL_SHIFT = 20
_INDEX_MASK = (1 << _LABEL_SHIFT) - 1


def kernel_length_ok(p: int) -> bool:
    """The row lengths the kernel sorts (the geometry rule of the
    per-image Lovász hinge, ``salt_tpu/losses/lovasz.py:110``)."""
    return 128 <= p <= MAX_LENGTH and p & (p - 1) == 0


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def sort_desc(keys: torch.Tensor, payload: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending sort of fp32 ``keys`` [B, P] along P, carrying the
    int32 ``payload`` [B, P]; by the CUDA kernel for a CUDA tensor."""
    global launches
    if keys.dtype != torch.float32:
        raise TypeError(f"sort kernel takes fp32 keys, got {keys.dtype}")
    if payload.dtype != torch.int32:
        raise TypeError(f"sort kernel takes an int32 payload, got "
                        f"{payload.dtype}")
    if keys.ndim != 2 or payload.shape != keys.shape:
        raise ValueError(f"sort kernel takes keys and payload [B, P] of one "
                         f"shape, got {tuple(keys.shape)} and "
                         f"{tuple(payload.shape)}")
    b, p = keys.shape
    if not kernel_length_ok(p):
        raise ValueError(f"sort kernel takes P a power of two in [128, "
                         f"{MAX_LENGTH}], got {p}")
    if payload.device != keys.device:
        raise ValueError(f"keys on {keys.device}, payload on "
                         f"{payload.device}")
    if keys.device.type == "cpu":
        return bitonic_sort_desc(keys, payload)
    if keys.device.type != "cuda":
        raise ValueError(f"sort kernel: unsupported device {keys.device}")
    if not (keys.is_contiguous() and payload.is_contiguous()):
        raise ValueError("sort kernel takes contiguous tensors")
    keys_out = torch.empty_like(keys)
    payload_out = torch.empty_like(payload)
    if b == 0:
        return keys_out, payload_out
    fn = build.function("bitonic_sort", "salt_bitonic_sort_desc", _ARGTYPES)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(keys.data_ptr(), payload.data_ptr(), keys_out.data_ptr(),
                payload_out.data_ptr(), b, p, stream)
    if rc != 0:
        raise RuntimeError(f"sort kernel launch failed: cudaError {rc}")
    launches += 1
    return keys_out, payload_out


class SortDescWithLabels(torch.autograd.Function):
    """Differentiable descending sort of ``errors`` [B, P] carrying the
    binary ``labels`` along. The payload packs ``label << 20 | index``,
    so one sort gives both the sorted labels and the permutation; the
    gradient flows through the errors only and is the scatter of the
    incoming gradient back through the permutation (``_sort_bwd``,
    ``pallas_sort.py:156-163``: plain code there too, no kernel)."""

    @staticmethod
    def forward(ctx, errors: torch.Tensor, labels: torch.Tensor):
        b, p = errors.shape
        iota = torch.arange(p, dtype=torch.int32, device=errors.device)
        packed = (labels.to(torch.int32) << _LABEL_SHIFT) | iota
        errors_sorted, packed_sorted = sort_desc(
            errors.to(torch.float32).contiguous(), packed.contiguous())
        labels_sorted = (packed_sorted >> _LABEL_SHIFT).to(torch.float32)
        perm = (packed_sorted & _INDEX_MASK).to(torch.int64)
        ctx.save_for_backward(perm)
        ctx.mark_non_differentiable(labels_sorted)
        return errors_sorted, labels_sorted

    @staticmethod
    def backward(ctx, g_errors_sorted, _g_labels_sorted):
        (perm,) = ctx.saved_tensors
        g = torch.zeros_like(g_errors_sorted)
        return g.scatter_(1, perm, g_errors_sorted), None


def lovasz_hinge_flat_kernel(logits: torch.Tensor, labels: torch.Tensor,
                             size_weighted: bool = False) -> torch.Tensor:
    """Lovász hinge of each row of flat [B, P] logits and {0, 1} labels
    through :class:`SortDescWithLabels`; the per-row losses [B]."""
    labels = labels.to(torch.float32)
    signs = 2.0 * labels - 1.0
    errors = 1.0 - logits.to(torch.float32) * signs
    if size_weighted:
        errors = weigh_errors_with_size(labels, errors)
    errors_sorted, gt_sorted = SortDescWithLabels.apply(errors, labels)
    grad = lovasz_grad(gt_sorted)
    return torch.sum(F.elu(errors_sorted) * grad, dim=-1)
