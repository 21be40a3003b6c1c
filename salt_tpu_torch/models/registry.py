"""Architecture registry (counterpart of ``salt_tpu/models/registry.py``
``build_model`` :176-197), and two seeded initializers: ``init_seeded``
(random weights and BN statistics, for the parity and serve checks) and
``init_flax_like`` (flax's default initializers, the start of training).

The port builds every architecture of the JAX registry: the U-Net
family (``UNetResNet`` 18-152, ``UNetSeResNet``, ``UNetSeResNetXt``,
``UNetDenseNet``), the depth-gated ``UNetResNetWithDepth``, the scratch
``SaltUNet`` / ``SaltLinkNet``, ``LargeKernelMatters``, ``PSPNet``,
``StackingFCN`` / ``StackingFCNWithDepth`` and ``EmptinessClassifier``,
with the arguments and ``encoder_depth`` coercions of JAX's build
functions (:55-158). ``model.pallas_conv`` and ``model.quant_bits``
select the infer form's conv callable (:func:`infer_conv_fn`, the
counterpart of ``_conv_fn``, ``salt_tpu/models/registry.py:35-52``); it
reaches the U-Nets and the depth net, as in the JAX package, which hands
the other architectures no conv callable. The port also hands the
scratch nets (``SaltUNet``, ``SaltLinkNet``) the int8 convs of
``model.quant_bits=8``, where the JAX package leaves them in full
precision (``models/salt_unet.py``). The depth model takes no
``pool0``, ``hypercolumn_impl`` or ``decoder_impl``, as its JAX build
function passes none.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from salt_tpu_torch.core.config import ModelConfig
from salt_tpu_torch.models.quant import make_conv_fn as make_quant_conv_fn
from salt_tpu_torch.ops.conv_pair import make_conv_fn

_MODE_CHOICES = {
    # string knobs are matched with == in the blocks; a typo silently
    # falling back to the default would defeat the reference-parity
    # modes, so validate at the single build choke point
    "conv_pad_mode": ("same", "reference"),
    "upsample_mode": ("half_pixel", "align_corners"),
    "hypercolumn_impl": ("sum", "concat"),
    "decoder_impl": ("sum", "concat"),
    "pallas_conv": ("off", "on", "auto"),
}

#: architectures of the JAX registry the port does not build: none
NOT_PORTED = ()
#: the U-Nets: their factory in ``models.unet``, the ``encoder_depth``s
#: their JAX builder keeps and the one it takes otherwise (None: 0 -> 34)
_UNETS = {"UNetResNet": (None, None),
          "UNetSeResNet": ((50, 101, 152), 50),
          "UNetSeResNetXt": ((50, 101), 50),
          "UNetDenseNet": ((121, 161, 169, 201), 121)}

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _lkm(cfg: ModelConfig) -> nn.Module:
    from salt_tpu_torch.models.large_kernel_matters import \
        LargeKernelMatters
    return LargeKernelMatters(num_classes=cfg.num_classes,
                              encoder_depth=cfg.encoder_depth or 34,
                              kernel_size=cfg.kernel_size,
                              internal_channels=21, use_relu=True,
                              pool0=cfg.pool0, pad_mode=cfg.conv_pad_mode)


def _pspnet(cfg: ModelConfig) -> nn.Module:
    from salt_tpu_torch.models.pspnet import PSPNet
    return PSPNet(num_classes=cfg.num_classes,
                  encoder_depth=cfg.encoder_depth or 34,
                  use_hypercolumn=cfg.use_hypercolumn, pool0=cfg.pool0,
                  pad_mode=cfg.conv_pad_mode,
                  upsample_mode=cfg.upsample_mode)


def _stacking(cfg: ModelConfig) -> nn.Module:
    from salt_tpu_torch.models import stacking
    cls = (stacking.StackingFCNWithDepth
           if cfg.architecture == "StackingFCNWithDepth"
           else stacking.StackingFCN)
    return cls(num_classes=cfg.num_classes,
               input_model_nr=cfg.input_model_nr, filter_nr=cfg.filter_nr,
               dropout_2d=cfg.dropout_2d, pad_mode=cfg.conv_pad_mode)


def _emptiness(cfg: ModelConfig) -> nn.Module:
    from salt_tpu_torch.models.emptiness import EmptinessClassifier
    return EmptinessClassifier(num_classes=cfg.num_classes,
                               encoder_depth=18)


def _scratch_conv(cfg: ModelConfig):
    """The scratch nets' infer conv: the int8 convs, or ``F.conv2d``."""
    return make_quant_conv_fn(cfg.quant_bits) or F.conv2d


def _salt_unet(cfg: ModelConfig) -> nn.Module:
    from salt_tpu_torch.models.salt_unet import SaltUNet
    return SaltUNet(num_classes=cfg.num_classes, n_filters=cfg.n_filters,
                    conv_kernel=cfg.conv_kernel,
                    repeat_blocks=cfg.repeat_blocks,
                    dropout_2d=cfg.dropout_2d,
                    infer_conv=_scratch_conv(cfg))


def _salt_linknet(cfg: ModelConfig) -> nn.Module:
    from salt_tpu_torch.models.salt_unet import SaltLinkNet
    return SaltLinkNet(num_classes=cfg.num_classes, n_filters=cfg.n_filters,
                       repeat_blocks=cfg.repeat_blocks,
                       infer_conv=_scratch_conv(cfg))


#: the architectures whose build functions take no ``infer_conv_fn`` (the
#: scratch nets take the int8 convs alone)
_OTHERS = {"SaltUNet": _salt_unet, "SaltLinkNet": _salt_linknet,
           "LargeKernelMatters": _lkm, "PSPNet": _pspnet,
           "StackingFCN": _stacking, "StackingFCNWithDepth": _stacking,
           "EmptinessClassifier": _emptiness}
#: every architecture the registry builds (the JAX ``ARCHITECTURES``)
ARCHITECTURES = (*_UNETS, "UNetResNetWithDepth", *_OTHERS)


def infer_conv_fn(cfg: ModelConfig):
    """The infer form's conv callable: ``F.conv2d``, or with
    ``quant_bits=8`` the int8 convs of ``models.quant.make_conv_fn``; for
    ``pallas_conv`` "on" and "auto" the dispatch that sends the eligible
    convs to the conv kernel and every other one to the former, as the
    JAX package's ``make_pallas_conv_fn(inner)`` composes the Pallas
    kernel with AQT. "auto" means the kernel wherever the tensors lie on
    the card, as it means the Pallas kernel on any device but a CPU in
    the JAX package; on the CPU both take the kernel's plain version."""
    inner = make_quant_conv_fn(cfg.quant_bits) or F.conv2d
    return inner if cfg.pallas_conv == "off" else make_conv_fn(inner=inner)


def build_model(cfg: ModelConfig) -> nn.Module:
    """An fp32 module in eval mode; ``set_compute_dtype`` casts it."""
    for field, choices in _MODE_CHOICES.items():
        val = getattr(cfg, field, choices[0])
        if val not in choices:
            raise ValueError(f"model.{field}={val!r}: expected one of "
                             f"{choices}")
    if cfg.architecture not in ARCHITECTURES:
        raise KeyError(f"unknown architecture {cfg.architecture!r}; "
                       f"choose from {sorted(ARCHITECTURES)}")
    make_quant_conv_fn(cfg.quant_bits)       # refuses widths other than 8
    if cfg.architecture in _OTHERS:
        return _OTHERS[cfg.architecture](cfg).eval()
    common = dict(num_classes=cfg.num_classes,
                  use_hypercolumn=cfg.use_hypercolumn,
                  dropout_2d=cfg.dropout_2d, pad_mode=cfg.conv_pad_mode,
                  upsample_mode=cfg.upsample_mode,
                  infer_conv=infer_conv_fn(cfg))
    if cfg.architecture == "UNetResNetWithDepth":
        from salt_tpu_torch.models.models_with_depth import \
            UNetResNetWithDepth
        return UNetResNetWithDepth(encoder_depth=cfg.encoder_depth or 34,
                                   **common).eval()
    from salt_tpu_torch.models import unet
    keep, default = _UNETS[cfg.architecture]
    if keep is None:
        depth = cfg.encoder_depth or 34
    else:
        depth = cfg.encoder_depth if cfg.encoder_depth in keep else default
    model = getattr(unet, cfg.architecture)(
        encoder_depth=depth, pool0=cfg.pool0,
        hypercolumn_impl=cfg.hypercolumn_impl,
        decoder_impl=cfg.decoder_impl, **common)
    return model.eval()


def takes_depth(architecture: str) -> bool:
    """Architectures whose forward takes the [B, 1] depth (the JAX
    registry's ``takes_depth``, :200-203)."""
    return architecture in ("UNetResNetWithDepth", "StackingFCNWithDepth")


def _fan_in(module: nn.Module) -> int:
    """The fan-in of flax's kernel initializers: inputs x kernel taps (a
    transposed conv's weight is [in, out, kh, kw])."""
    shape = module.weight.shape
    if isinstance(module, nn.ConvTranspose2d):
        return int(shape[0] * np.prod(shape[2:]))
    return int(np.prod(shape[1:]))


_KERNELS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


@torch.no_grad()
def init_seeded(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and BN statistic from ``numpy`` seed ``seed``:
    conv/linear weights N(0, 1/fan_in), biases 0.05 N(0, 1), BN scale and
    variance U(0.8, 1.2), BN shift and mean 0.1 N(0, 1), a PReLU's alpha
    0.25 + 0.05 N(0, 1)."""
    rng = np.random.RandomState(seed)

    def fill(t: torch.Tensor, values: np.ndarray):
        t.copy_(torch.from_numpy(np.asarray(values, np.float32)))

    for module in model.modules():
        if isinstance(getattr(module, "prelu_alpha", None), nn.Parameter):
            fill(module.prelu_alpha, 0.25 + 0.05 * rng.randn())
        if isinstance(module, _KERNELS):
            w = module.weight
            fill(w, rng.randn(*w.shape) / np.sqrt(_fan_in(module)))
            if module.bias is not None:
                fill(module.bias, 0.05 * rng.randn(*module.bias.shape))
        elif isinstance(module, nn.BatchNorm2d):
            c = module.num_features
            fill(module.weight, 0.8 + 0.4 * rng.rand(c))
            fill(module.bias, 0.1 * rng.randn(c))
            fill(module.running_mean, 0.1 * rng.randn(c))
            fill(module.running_var, 0.8 + 0.4 * rng.rand(c))
    return model


@torch.no_grad()
def init_flax_like(model: nn.Module, seed: int) -> nn.Module:
    """Flax's default initialization, drawn from ``torch.Generator`` seed
    ``seed``: conv and dense kernels ``lecun_normal`` (a normal truncated
    at +-2 std, std sqrt(1 / fan_in) / 0.8796), biases 0, BN scale 1,
    shift 0, mean 0, variance 1, a PReLU's alpha 0.25. The distribution
    of the JAX package's init, not its bits."""
    g = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(getattr(module, "prelu_alpha", None), nn.Parameter):
            module.prelu_alpha.fill_(0.25)
        if isinstance(module, _KERNELS):
            w = module.weight
            std = (1.0 / _fan_in(module)) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=g)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.BatchNorm2d):
            module.reset_parameters()
    return model
