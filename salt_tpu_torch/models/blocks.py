"""Building blocks of the port's networks, as torch ``nn.Module``s in NCHW:
the U-Nets' (ConvBnRelu, the scSE decoder, the depth gate, the fp32
head), LargeKernelMatters' (the transposed conv, the global
convolutional network, the boundary refinement) and PSPNet's (any-size
bilinear resize).

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
``model.pallas_conv`` routes the eligible convs to the conv kernel, and
``models.quant.make_conv_fn(8)`` for ``model.quant_bits=8``.
:class:`ConvBnRelu` applied to a list of branches is the JAX package's
``SlicedConcatConvBnRelu`` (:func:`sliced_concat_conv` its
``SlicedConcatConv``): the same ``Conv_0`` / ``BatchNorm_0`` parameters as
the literal concat, so checkpoints load into both forms unchanged.

BatchNorm: eps 1e-5 (flax momentum 0.9 == torch momentum 0.1). In
training it normalises with the batch's biased variance and, as flax
does, moves ``running_var`` towards that biased variance too
(:class:`BatchNorm2d`; ``nn.BatchNorm2d`` uses the unbiased one there).
Inside :func:`functional_batch_norm` the training forward computes the
statistics itself and hands the new running ones to a
:class:`BatchStats` (under ``torch.func`` transforms, which cannot move
a buffer in place), and over a process group it reduces them over the
group's whole batch (data parallelism).

Channel dropout draws from a ``torch.Generator``, or takes its uniform
draws from a :class:`DropoutDraws` made in advance (``vmap`` cannot draw
from a generator).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
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


def _half_pixel_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of ``jax.image.resize(method="linear")``
    along one axis (``jax/_src/image/scale.py`` ``compute_weight_mat``, in
    float32 as JAX computes them): a triangle kernel at the half-pixel
    sample positions, widened by n_in / n_out when shrinking (JAX
    antialiases), each output's weights normalised to sum to 1."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0), np.float32(1) - x / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).T.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int, mode: str, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """The [n_out, n_in] interpolation matrix of ``mode`` on ``device``,
    made once (a host-to-device copy on every call would stall the
    host)."""
    m = (_align_corners_matrix(n_in, n_out) if mode == "align_corners"
         else _half_pixel_matrix(n_in, n_out))
    return torch.from_numpy(m).to(device, dtype)


def _resize_by_matrices(x: torch.Tensor, out_h: int, out_w: int,
                        mode: str) -> torch.Tensor:
    h, w = x.shape[-2:]
    wh = _resize_matrix(h, out_h, mode, x.device, x.dtype)
    ww = _resize_matrix(w, out_w, mode, x.device, x.dtype)
    y = torch.einsum("oh,bchw->bcow", wh, x)
    return torch.einsum("pw,bcow->bcop", ww, y)


def upsample2x(x: torch.Tensor, factor: int = 2,
               mode: str = "half_pixel") -> torch.Tensor:
    """Bilinear NCHW upsample by an integer ``factor``."""
    h, w = x.shape[-2:]
    if mode == "align_corners":
        return _resize_by_matrices(x, h * factor, w * factor, mode)
    return F.interpolate(x, size=(h * factor, w * factor), mode="bilinear",
                         align_corners=False)


def _pair(k: Union[int, Sequence[int]]) -> Tuple[int, int]:
    return (k, k) if isinstance(k, int) else (int(k[0]), int(k[1]))


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    mode: str = "half_pixel") -> torch.Tensor:
    """Bilinear NCHW resize to any (``out_h``, ``out_w``)
    (``salt_tpu/models/blocks.py`` ``resize_bilinear`` :108-124):
    "half_pixel" is ``jax.image.resize``'s "linear", antialiased where it
    shrinks (:func:`_half_pixel_matrix`), "align_corners" the matrices of
    :func:`upsample2x`; both as two small matrix products."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return _resize_by_matrices(x, out_h, out_w, mode)


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
        if _FUNCTIONAL_BN is not None:
            return self._functional_forward(x, *_FUNCTIONAL_BN)
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

    def _functional_forward(self, x: torch.Tensor,
                            stats: Optional["BatchStats"],
                            group) -> torch.Tensor:
        """The training forward with the batch statistics computed here,
        in fp32 at least (the fused kernel's accumulation): the mean,
        then the biased variance about it; over ``group``'s whole batch
        when a process group is given (each a sum all-reduced, equal
        shards assumed). The new running statistics go to ``stats``, or,
        without one, into the buffers in place."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        n = xf.numel() // xf.shape[1]
        if group is not None:
            n *= dist.get_world_size(group)

        def channel_sum(t):
            t = t.sum((0, 2, 3))
            if group is None:
                return t
            from salt_tpu_torch.parallel.mesh import all_reduce_sum
            return all_reduce_sum(t, group)

        mean = channel_sum(xf) / n
        centred = xf - mean[None, :, None, None]
        var = channel_sum(centred.square()) / n
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = centred * scale[None, :, None, None] + self.bias[None, :, None,
                                                             None]
        m = self.momentum
        new_mean = self.running_mean * (1 - m) + mean.detach() * m
        new_var = self.running_var * (1 - m) + var.detach() * m
        if stats is not None:
            stats.put(self, new_mean, new_var)
        else:
            with torch.no_grad():
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
        return y.to(x.dtype)


class BatchStats:
    """The new running statistics of one functional training forward,
    by buffer name (``<module>.running_mean`` / ``.running_var``);
    ``names`` maps each BatchNorm module's ``id`` to its name in the
    model (``named_modules()``)."""

    def __init__(self, names: Dict[int, str]):
        self._names = names
        self.values: Dict[str, torch.Tensor] = {}

    def put(self, module: "BatchNorm2d", mean: torch.Tensor,
            var: torch.Tensor) -> None:
        prefix = self._names[id(module)]
        self.values[f"{prefix}.running_mean"] = mean
        self.values[f"{prefix}.running_var"] = var


#: (stats, process group) while :func:`functional_batch_norm` is active
_FUNCTIONAL_BN = None


@contextlib.contextmanager
def functional_batch_norm(stats: Optional[BatchStats] = None, group=None):
    """Within: every :class:`BatchNorm2d` in training computes its batch
    statistics itself (over ``group``'s whole batch when given) and puts
    the new running ones into ``stats`` (in place when None)."""
    global _FUNCTIONAL_BN
    previous = _FUNCTIONAL_BN
    _FUNCTIONAL_BN = (stats, group)
    try:
        yield stats
    finally:
        _FUNCTIONAL_BN = previous


class DropoutDraws:
    """The uniform draws of a forward's channel dropout sites, made in
    advance, in the order the forward reaches the sites; passed where a
    forward takes its ``generator``. Without draws it records each
    site's [B, C] and leaves the features as they are (in either mode),
    which tells the caller what to draw."""

    def __init__(self, draws: Optional[Sequence[torch.Tensor]] = None):
        self.draws = None if draws is None else list(draws)
        self.shapes: List[Tuple[int, int]] = []

    def take(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The next site's draws [B, C, 1, 1] for ``x`` (None when
        recording)."""
        self.shapes.append(tuple(x.shape[:2]))
        if self.draws is None:
            return None
        return self.draws[len(self.shapes) - 1]


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
    """kh x kw conv (stride 1) -> BN -> ReLU (``salt_tpu/models/blocks.py``
    ``ConvBnRelu`` :133-162). ``kernel_size`` is k or (kh, kw); without
    BatchNorm the conv has a bias, as flax's ``use_bias=not
    use_batch_norm``, and ``use_relu=False`` leaves the ReLU out. SAME
    padding is flax's: k - 1 rows (columns), (k - 1) // 2 of them before,
    so an even k pads one more after. Given a list of branches (3x3 only)
    it convolves their implicit concat (the JAX package's
    ``SlicedConcatConvBnRelu``, :278-297)."""

    def __init__(self, in_channels: int, features: int,
                 pad_mode: str = "same",
                 kernel_size: Union[int, Tuple[int, int]] = 3,
                 use_batch_norm: bool = True, use_relu: bool = True):
        super().__init__()
        self.pad_mode = pad_mode
        self.use_relu = use_relu
        kh, kw = self.kernel_size = _pair(kernel_size)
        # an odd SAME conv pads inside the conv; otherwise F.pad first
        self.pad_first = pad_mode == "reference" or kh % 2 == 0 \
            or kw % 2 == 0
        self.Conv_0 = nn.Conv2d(in_channels, features, (kh, kw),
                                padding=0 if self.pad_first
                                else (kh // 2, kw // 2),
                                bias=not use_batch_norm)
        self.BatchNorm_0 = batch_norm(features) if use_batch_norm else None

    def forward(self, x: Union[torch.Tensor, List[torch.Tensor]],
                conv: Conv = F.conv2d) -> torch.Tensor:
        kh, kw = self.kernel_size
        if isinstance(x, (list, tuple)):
            if (kh, kw) != (3, 3):
                raise ValueError(f"a sliced concat conv is 3x3, not "
                                 f"{kh}x{kw}")
            y = sliced_concat_conv(x, self.Conv_0.weight, conv, self.pad_mode)
        else:
            if self.pad_mode == "reference":
                x = reference_pad(x, kh, kw)
            elif self.pad_first:
                x = F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
            y = apply_conv(conv, self.Conv_0, x)
        if self.BatchNorm_0 is not None:
            y = self.BatchNorm_0(y)
        return F.relu(y) if self.use_relu else y


class DeconvConvBnRelu(nn.Module):
    """Stride-2 3x3 transposed conv -> BN -> ReLU, doubling H and W
    (``salt_tpu/models/blocks.py`` ``DeconvConvBnRelu`` :164-192).

    flax's ``ConvTranspose`` does not flip its kernel: it is
    ``lax.conv_transpose``, the cross-correlation of the stride-dilated
    input (a zero between each two pixels) with the kernel, padded (2, 1)
    on each spatial axis in "same" (``lax``'s SAME rule at k 3, stride 2)
    and (1, 2) in ``pad_mode="reference"``. ``F.conv_transpose2d`` of the
    spatially flipped kernel computes that sum padded (2 - p) on both
    sides: p = 0 with the last row and column cropped gives (2, 1), p = 1
    with ``output_padding`` 1 gives (1, 2). ``ConvTranspose_0.weight``
    [in, out, 3, 3] holds flax's [3, 3, in, out] kernel transposed and
    unflipped (``models.convert``)."""

    def __init__(self, in_channels: int, features: int,
                 pad_mode: str = "same", use_relu: bool = True,
                 use_batch_norm: bool = True):
        super().__init__()
        self.pad_mode = pad_mode
        self.use_relu = use_relu
        self.ConvTranspose_0 = nn.ConvTranspose2d(
            in_channels, features, 3, stride=2, bias=not use_batch_norm)
        self.BatchNorm_0 = batch_norm(features) if use_batch_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.ConvTranspose_0
        w = m.weight.flip(2, 3)
        if self.pad_mode == "reference":
            y = F.conv_transpose2d(x, w, m.bias, stride=2, padding=1,
                                   output_padding=1)
        else:
            y = F.conv_transpose2d(x, w, m.bias, stride=2)[..., :-1, :-1]
        if self.BatchNorm_0 is not None:
            y = self.BatchNorm_0(y)
        return F.relu(y) if self.use_relu else y


class GlobalConvolutionalNetwork(nn.Module):
    """The factorized large kernel (``salt_tpu/models/blocks.py``
    ``GlobalConvolutionalNetwork`` :373-393): a k x 1 then 1 x k branch
    plus a 1 x k then k x 1 branch, each conv a :class:`ConvBnRelu`."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 use_relu: bool = False, pad_mode: str = "same"):
        super().__init__()
        k = kernel_size
        for i, (c_in, shape) in enumerate(((in_channels, (k, 1)),
                                           (features, (1, k)),
                                           (in_channels, (1, k)),
                                           (features, (k, 1)))):
            self.add_module(f"ConvBnRelu_{i}", ConvBnRelu(
                c_in, features, pad_mode, shape, use_relu=use_relu))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.ConvBnRelu_1(self.ConvBnRelu_0(x))
        return a + self.ConvBnRelu_3(self.ConvBnRelu_2(x))


class BoundaryRefinement(nn.Module):
    """x + conv-BN-ReLU-conv-BN of x (``salt_tpu/models/blocks.py``
    ``BoundaryRefinement`` :396-410)."""

    def __init__(self, features: int, kernel_size: int = 3,
                 pad_mode: str = "same"):
        super().__init__()
        k = kernel_size
        self.ConvBnRelu_0 = ConvBnRelu(features, features, pad_mode, k)
        self.ConvBnRelu_1 = ConvBnRelu(features, features, pad_mode, k,
                                       use_relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.ConvBnRelu_1(self.ConvBnRelu_0(x))


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
        ``generator``, or taken from a :class:`DropoutDraws` (in either
        mode)."""
        if not self.dropout_2d > 0:
            return x
        if isinstance(generator, DropoutDraws):
            u = generator.take(x)
            if u is None:
                return x
        elif not self.training:
            return x
        else:
            u = torch.rand((*x.shape[:2], 1, 1), generator=generator,
                           device=x.device)
        keep = 1.0 - self.dropout_2d
        return torch.where(u < keep, x / keep, 0.0)
