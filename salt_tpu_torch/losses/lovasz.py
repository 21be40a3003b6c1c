"""Lovász hinge / softmax losses and the stable BCE (counterpart of
``salt_tpu/losses/lovasz.py`` :26-157).

Tensors keep the JAX package's layout at these functions: the hinge
takes [B, ...] logits and labels of one shape and flattens each image in
that order, so the port's loss gets NHWC [B, H, W, 2] logits as the JAX
loss does (``logits.permute(0, 2, 3, 1)`` of the model's channels_last
output is a view).

Sorting. The per-image hinge over rows whose length the sort kernel
takes (a power of two, a multiple of 128, at most 32,768; the
production 2 x 128 x 128 = 32,768 qualifies) goes through
``ops.sort_kernel``: the CUDA kernel for a CUDA tensor, the plain
bitonic network for a CPU tensor. Every other shape sorts with
``torch.sort(-errors, stable=True)``, the counterpart of
``lax.sort_key_val``. Shape alone decides. The value does not depend on
how ties are ordered (a tied block contributes ``elu(e) * sum(grad)``);
the gradient does, and follows the network's order on the kernel path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. sorted errors, along the
    last axis (reference: lovasz_losses.py:21-33); {0, 1} floats."""
    gts = gt_sorted.sum(dim=-1, keepdim=True)
    intersection = gts - gt_sorted.cumsum(dim=-1)
    union = gts + (1.0 - gt_sorted).cumsum(dim=-1)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[..., :1],
                      jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)


def weigh_errors_with_size(labels: torch.Tensor, errors: torch.Tensor
                           ) -> torch.Tensor:
    """Inverse-foreground-fraction error weighting along the last axis
    (reference: lovasz_losses.py:118-129): foreground errors scale by
    P / size; rows with an empty mask pass through unchanged."""
    p = errors.shape[-1]
    size = labels.sum(dim=-1, keepdim=True)
    size_weight = p / torch.clamp(size, min=1.0)
    weights = torch.where(labels > 0.5, size_weight, 1.0)
    return torch.where(size == 0, errors, errors * weights)


def lovasz_hinge_flat(logits: torch.Tensor, labels: torch.Tensor,
                      size_weighted: bool = False) -> torch.Tensor:
    """Binary Lovász hinge along the last axis of [..., P] logits and
    labels, sorted by the stable ``torch.sort``; one loss per row."""
    labels = labels.to(torch.float32)
    signs = 2.0 * labels - 1.0
    errors = 1.0 - logits.to(torch.float32) * signs
    if size_weighted:
        errors = weigh_errors_with_size(labels, errors)
    neg_sorted, perm = torch.sort(-errors, dim=-1, stable=True)
    gt_sorted = labels.gather(-1, perm)
    grad = lovasz_grad(gt_sorted)
    return torch.sum(F.elu(-neg_sorted) * grad, dim=-1)


def lovasz_hinge(logits: torch.Tensor, labels: torch.Tensor,
                 per_image: bool = True,
                 size_weighted: bool = False) -> torch.Tensor:
    """Batch Lovász hinge over [B, ...] logits and labels of one shape
    (the reference feeds the full one-hot pair; each image flattens
    before sorting)."""
    b = logits.shape[0]
    flat_logits = logits.reshape(b, -1)
    flat_labels = labels.reshape(b, -1)
    if not per_image:
        return lovasz_hinge_flat(flat_logits.reshape(-1),
                                 flat_labels.reshape(-1), size_weighted)
    from salt_tpu_torch.ops.sort_kernel import (kernel_length_ok,
                                                lovasz_hinge_flat_kernel)
    if kernel_length_ok(flat_logits.shape[-1]):
        losses = lovasz_hinge_flat_kernel(flat_logits, flat_labels,
                                          size_weighted)
    else:
        losses = lovasz_hinge_flat(flat_logits, flat_labels, size_weighted)
    return losses.mean()


def lovasz_softmax_flat(probas: torch.Tensor, labels: torch.Tensor,
                        classes: int) -> torch.Tensor:
    """Multi-class Lovász-Softmax over [..., P, C] probabilities and
    [..., P] integer labels (reference: lovasz_losses.py:191-210); the
    mean over classes, per leading index."""
    losses = []
    for c in range(classes):
        fg = (labels == c).to(torch.float32)
        errors = torch.abs(fg - probas[..., c])
        neg_sorted, perm = torch.sort(-errors, dim=-1, stable=True)
        grad = lovasz_grad(fg.gather(-1, perm))
        losses.append(torch.sum(-neg_sorted * grad, dim=-1))
    return torch.stack(losses).mean(dim=0)


def lovasz_softmax(probas: torch.Tensor, labels: torch.Tensor,
                   per_image: bool = False) -> torch.Tensor:
    """probas: [B, H, W, C] class probabilities; labels: [B, H, W] ints
    (reference: lovasz_losses.py:173-188, NHWC as in the JAX package)."""
    c = probas.shape[-1]
    flat_p = probas.reshape(probas.shape[0], -1, c)
    flat_l = labels.reshape(labels.shape[0], -1)
    if per_image:
        return lovasz_softmax_flat(flat_p, flat_l, c).mean()
    return lovasz_softmax_flat(flat_p.reshape(-1, c), flat_l.reshape(-1), c)


def stable_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                           ) -> torch.Tensor:
    """Numerically stable BCE-with-logits, mean-reduced (reference:
    lovasz_losses.py:148-155 ``StableBCELoss``)."""
    logits = logits.to(torch.float32)
    targets = targets.to(torch.float32)
    loss = (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return loss.mean()
