"""Building blocks of the flagship U-Net, as torch ``nn.Module``s in NCHW.

Counterparts of ``salt_tpu/models/blocks.py``. Submodule names copy the
flax scope names (``Conv_0``, ``BatchNorm_0``, ``ConvBnRelu_0``,
``ChannelSELayer_0``, ``Dense_0``, ...) so ``models.convert`` maps a flax
checkpoint path to a torch state_dict key by joining names; modules whose
name starts with ``Dense`` hold flax ``Dense`` kernels.

Reference-parity modes, as in the JAX package:
- ``pad_mode="reference"``: replication pad kh-1 rows on top and kw-1
  columns on the right, then a VALID conv;
- ``upsample_mode="align_corners"``: bilinear with align_corners=True,
  applied as two interpolation matrices like the JAX package.
The defaults are centred SAME padding and half-pixel bilinear
(``jax.image.resize`` "linear" == ``F.interpolate(align_corners=False)``
for these integer upsampling factors, edges included; tested).

Convolutions take a ``conv`` callable with ``F.conv2d``'s signature, the
counterpart of the JAX package's ``conv_fn`` injection: ``F.conv2d``
itself in the train form, ``ops.conv_pair.make_conv_fn()`` where
``model.pallas_conv`` routes the eligible convs to the conv kernel.
:class:`ConvBnRelu` applied to a list of branches is the JAX package's
``SlicedConcatConvBnRelu`` (:func:`sliced_concat_conv` its
``SlicedConcatConv``): the same ``Conv_0`` / ``BatchNorm_0`` parameters as
the literal concat, so checkpoints load into both forms unchanged.

BatchNorm: eps 1e-5 (flax momentum 0.9 == torch momentum 0.1). In
training it normalises with the batch's biased variance and, as flax
does, moves ``running_var`` towards that biased variance too
(:class:`BatchNorm2d`; ``nn.BatchNorm2d`` uses the unbiased one there).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1

#: a convolution with ``F.conv2d``'s signature
Conv = Callable[..., torch.Tensor]


def _align_corners_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Two-tap interpolation matrix [n_out, n_in], src = i * (n_in - 1) /
    (n_out - 1), weights computed in float64 as the JAX package does (the
    float32 source coordinate of ``F.interpolate`` is off by up to ~1e-5
    at these sizes)."""
    if n_in == 1 or n_out == 1:
        return np.ones((n_out, n_in), np.float32) / n_in
    src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.floor(src).astype(np.int64)
    frac = (src - lo).astype(np.float32)
    hi = np.minimum(lo + 1, n_in - 1)
    w = np.zeros((n_out, n_in), np.float32)
    w[np.arange(n_out), lo] += 1.0 - frac
    w[np.arange(n_out), hi] += frac
    return w


def upsample2x(x: torch.Tensor, factor: int = 2,
               mode: str = "half_pixel") -> torch.Tensor:
    """Bilinear NCHW upsample by an integer ``factor``."""
    h, w = x.shape[-2:]
    if mode == "align_corners":
        wh, ww = (torch.from_numpy(_align_corners_matrix(n, n * factor))
                  .to(x.device, x.dtype) for n in (h, w))
        y = torch.einsum("oh,bchw->bcow", wh, x)
        return torch.einsum("pw,bcow->bcop", ww, y)
    return F.interpolate(x, size=(h * factor, w * factor), mode="bilinear",
                         align_corners=False)


def reference_pad(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """kh-1 replicated rows on TOP, kw-1 columns on the RIGHT."""
    return F.pad(x, (0, kw - 1, kh - 1, 0), mode="replicate")


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training step updates ``running_var``
    with the biased batch variance, as flax's ``BatchNorm`` does.

    The fused kernel moves the buffer by ``m * var * n / (n - 1)`` (the
    unbiased variance of n values per channel); the biased variance it
    normalised with comes back from its ``1 / sqrt(var + eps)``, and
    ``m * var / (n - 1)`` is taken off again (with one value a channel
    the buffer is set from its value before the call). The buffer is changed
    through ``.data``: autograd saved it, but the training backward does
    not read it. ``num_batches_tracked`` stays 0 (the momentum is fixed,
    so nothing reads it)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        old_var = self.running_var.detach().clone() if n == 1 else None
        y, _, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            True, self.momentum, self.eps)
        with torch.no_grad():
            var = invstd.pow(-2).sub_(self.eps)
            if old_var is None:
                self.running_var.data.sub_(var, alpha=self.momentum / (n - 1))
            else:
                # one value a channel: the fused update divides by n - 1
                # and writes NaN; flax moves the buffer towards 0
                self.running_var.data.copy_(old_var.mul_(1 - self.momentum)
                                            .add_(var, alpha=self.momentum))
        return y


def batch_norm(features: int) -> BatchNorm2d:
    return BatchNorm2d(features, eps=_BN_EPS, momentum=_BN_MOMENTUM)


def apply_conv(conv: Conv, module: nn.Conv2d,
               x: torch.Tensor) -> torch.Tensor:
    """``module``'s convolution of ``x`` through ``conv``."""
    return conv(x, module.weight, module.bias, module.stride, module.padding,
                module.dilation, module.groups)


def sliced_concat_conv(branches: Sequence[torch.Tensor], weight: torch.Tensor,
                       conv: Conv = F.conv2d,
                       pad_mode: str = "same") -> torch.Tensor:
    """3x3 conv over the implicit channel concat of ``branches``: the
    [F, sum(C_i), 3, 3] ``weight`` sliced per branch, each branch
    convolved on its own and the results summed in branch order, in the
    branches' dtype (``salt_tpu/models/blocks.py`` ``SlicedConcatConv``
    :232-275). In ``pad_mode="reference"`` each branch is padded first
    (the pad commutes with the channel split), then a VALID conv."""
    padding = 1
    if pad_mode == "reference":
        branches = [reference_pad(b, 3, 3) for b in branches]
        padding = 0
    out = None
    off = 0
    for b in branches:
        c = b.shape[1]
        y = conv(b, weight[:, off:off + c], None, 1, padding)
        out = y if out is None else out + y
        off += c
    if off != weight.shape[1]:
        raise ValueError(f"branches carry {off} channels, the kernel "
                         f"{weight.shape[1]}")
    return out


class ConvBnRelu(nn.Module):
    """k x k conv (stride 1) -> BN -> ReLU (``salt_tpu/models/blocks.py``
    ``ConvBnRelu`` :133-162). Without BatchNorm the conv has a bias, as
    flax's ``use_bias=not use_batch_norm``. SAME padding is flax's: k - 1
    rows and columns, (k - 1) // 2 of them before, so an even k pads one
    more after. Given a list of branches (3x3 only) it convolves their
    implicit concat (the JAX package's ``SlicedConcatConvBnRelu``,
    :278-297)."""

    def __init__(self, in_channels: int, features: int,
                 pad_mode: str = "same", kernel_size: int = 3,
                 use_batch_norm: bool = True):
        super().__init__()
        self.pad_mode = pad_mode
        self.kernel_size = k = kernel_size
        # an odd SAME conv pads inside the conv; otherwise F.pad first
        self.pad_first = pad_mode == "reference" or k % 2 == 0
        self.Conv_0 = nn.Conv2d(in_channels, features, k,
                                padding=0 if self.pad_first else k // 2,
                                bias=not use_batch_norm)
        self.BatchNorm_0 = batch_norm(features) if use_batch_norm else None

    def forward(self, x: Union[torch.Tensor, List[torch.Tensor]],
                conv: Conv = F.conv2d) -> torch.Tensor:
        k = self.kernel_size
        if isinstance(x, (list, tuple)):
            if k != 3:
                raise ValueError(f"a sliced concat conv is 3x3, not {k}x{k}")
            y = sliced_concat_conv(x, self.Conv_0.weight, conv, self.pad_mode)
        else:
            if self.pad_mode == "reference":
                x = reference_pad(x, k, k)
            elif self.pad_first:
                lo, hi = (k - 1) // 2, k // 2
                x = F.pad(x, (lo, hi, lo, hi))
            y = apply_conv(conv, self.Conv_0, x)
        if self.BatchNorm_0 is not None:
            y = self.BatchNorm_0(y)
        return F.relu(y)


class ChannelSELayer(nn.Module):
    """Squeeze-and-excitation over channels (reduction 16)."""

    def __init__(self, channels: int):
        super().__init__()
        hidden = max(channels // 16, 1)
        self.Dense_0 = nn.Linear(channels, hidden)
        self.Dense_1 = nn.Linear(hidden, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=(2, 3))
        y = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(y))))
        return x * y[:, :, None, None]


class SpatialSELayer(nn.Module):
    """Squeeze-and-excitation over space. The JAX package's ``Dense(1)``
    over the channel axis is a 1x1 conv with bias."""

    def __init__(self, channels: int):
        super().__init__()
        self.Dense_0 = nn.Conv2d(channels, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.Dense_0(x))


class DecoderBlock(nn.Module):
    """Upsample -> skip concat -> 2x ConvBnRelu -> relu(cSE + sSE).

    ``sliced=True`` is the JAX package's ``use_sliced_concat``
    (:300-340): the first conv takes the upsampled input and the skip as
    two branches instead of their concat."""

    def __init__(self, in_channels: int, skip_channels: int,
                 middle_features: int, features: int, pad_mode: str = "same",
                 upsample_mode: str = "half_pixel"):
        super().__init__()
        self.upsample_mode = upsample_mode
        self.ConvBnRelu_0 = ConvBnRelu(in_channels + skip_channels,
                                       middle_features, pad_mode=pad_mode)
        self.ConvBnRelu_1 = ConvBnRelu(middle_features, features,
                                       pad_mode=pad_mode)
        self.ChannelSELayer_0 = ChannelSELayer(features)
        self.SpatialSELayer_0 = SpatialSELayer(features)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                conv: Conv = F.conv2d, sliced: bool = False) -> torch.Tensor:
        x = upsample2x(x, mode=self.upsample_mode)
        if skip is not None:
            branches = [x, skip.to(x.dtype)]
            x = branches if sliced else torch.cat(branches, dim=1)
        x = self.ConvBnRelu_1(self.ConvBnRelu_0(x, conv), conv)
        return F.relu(self.ChannelSELayer_0(x) + self.SpatialSELayer_0(x))


class DepthChannelExcitation(nn.Module):
    """A per-channel gate from the scalar depth (``salt_tpu/models/
    blocks.py`` :343-353): ``Dense_0`` maps the [B, 1] depth, cast to the
    features' dtype, to C channels, then sigmoid, multiplied over H and
    W."""

    def __init__(self, channels: int):
        super().__init__()
        self.Dense_0 = nn.Linear(1, channels)

    def forward(self, x: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        d = depth.reshape(depth.shape[0], 1).to(x.dtype)
        return x * torch.sigmoid(self.Dense_0(d))[:, :, None, None]


class Fp32HeadNet(nn.Module):
    """A segmentation network whose 1x1 head (the submodule named
    ``head_name``) runs in fp32 on an fp32 copy of its input, so the
    logits come out fp32, as in the JAX package. A subclass computes the
    features in :meth:`_trunk` and calls :meth:`_channel_dropout` where
    its flax model has ``nn.Dropout(broadcast_dims=(1, 2))``.

    Two precisions:
    - serving (:meth:`set_compute_dtype`): every submodule but the head
      is cast to the dtype and computes in it;
    - training (:meth:`set_training_precision`): every parameter stays
      fp32, as flax keeps them, and the trunk computes in the dtype under
      ``torch.autocast``, so the optimizer never updates a bf16 copy.
    """

    head_name = "head"
    #: whether ``forward`` takes the [B, 1] depth (``registry.takes_depth``)
    takes_depth = False

    def __init__(self, dropout_2d: float = 0.0):
        super().__init__()
        self.dropout_2d = dropout_2d
        self.compute_dtype = torch.float32
        self.autocast_dtype: Optional[torch.dtype] = None

    def set_compute_dtype(self, dtype: torch.dtype) -> "Fp32HeadNet":
        """Serving precision: cast every module but the fp32 head to
        ``dtype``."""
        self.compute_dtype = dtype
        self.autocast_dtype = None
        for name, child in self.named_children():
            child.to(torch.float32 if name == self.head_name else dtype)
        return self

    def set_training_precision(self, dtype: torch.dtype) -> "Fp32HeadNet":
        """Training precision: fp32 parameters, the trunk computing in
        ``dtype`` under autocast (plain fp32 when ``dtype`` is fp32)."""
        self.set_compute_dtype(torch.float32)
        if dtype != torch.float32:
            self.autocast_dtype = dtype
        return self

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                infer: bool = False,
                depth: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, 3, H, W] -> fp32 logits [B, num_classes, H, W]; the infer
        form with ``infer=True``. A depth model takes ``depth`` [B, 1] and
        no other model does: either mistake raises ``TypeError``, as the
        flax model's call does."""
        if (depth is not None) != self.takes_depth:
            raise TypeError(
                f"{type(self).__name__}.forward() "
                + ("requires the depth input" if self.takes_depth else
                   "takes no depth input (execution.use_depth needs a "
                   "depth model, UNetResNetWithDepth)"))
        extra = (depth,) if self.takes_depth else ()
        if x.device.type == "cpu":
            # NCHW on the CPU: its channels-last kernels on one thread put
            # a train step's fp32 gradients 4% of a leaf's max from
            # float64 (tests/test_torch_train_step.py's input), NCHW 1e-3
            x = x.contiguous()
        if self.autocast_dtype is None:
            y = self._trunk(x.to(self.compute_dtype), generator, infer, *extra)
        else:
            with torch.autocast(x.device.type, dtype=self.autocast_dtype):
                y = self._trunk(x.to(torch.float32), generator, infer, *extra)
        head = getattr(self, self.head_name)
        return head(y.to(torch.promote_types(y.dtype, torch.float32)))

    def _trunk(self, x: torch.Tensor, generator: Optional[torch.Generator],
               infer: bool) -> torch.Tensor:
        raise NotImplementedError

    def _channel_dropout(self, x: torch.Tensor,
                         generator: Optional[torch.Generator]) -> torch.Tensor:
        """Whole channels zeroed with probability ``dropout_2d`` in train
        mode, the rest scaled by 1 / keep; the mask drawn from
        ``generator``."""
        if not (self.dropout_2d > 0 and self.training):
            return x
        keep = 1.0 - self.dropout_2d
        mask = torch.rand((*x.shape[:2], 1, 1), generator=generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)
