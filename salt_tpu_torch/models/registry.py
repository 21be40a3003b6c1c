"""Architecture registry (counterpart of ``salt_tpu/models/registry.py``
``build_model`` :176-197), and two seeded initializers: ``init_seeded``
(random weights and BN statistics, for the parity and serve checks) and
``init_flax_like`` (flax's default initializers, the start of training).

The port builds ``UNetResNet``, ``SaltUNet`` and ``SaltLinkNet``; every
other architecture the JAX package registers raises
``NotImplementedError`` naming the ROADMAP item that ports it.
``model.pallas_conv`` selects the infer form's conv callable
(:func:`infer_conv_fn`, the counterpart of ``_conv_fn``,
``salt_tpu/models/registry.py:35-52``); it reaches the UNetResNet only,
as the JAX package hands the scratch nets no conv callable.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from salt_tpu_torch.core.config import ModelConfig
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

#: architectures of the JAX registry the port does not build yet
NOT_PORTED = ("UNetSeResNet", "UNetSeResNetXt", "UNetDenseNet",
              "UNetResNetWithDepth", "LargeKernelMatters", "PSPNet",
              "StackingFCN", "StackingFCNWithDepth", "EmptinessClassifier")

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def infer_conv_fn(cfg: ModelConfig):
    """``F.conv2d`` for ``pallas_conv="off"``; for "on" and "auto" the
    dispatch that sends the eligible convs to the conv kernel. "auto"
    means the kernel wherever the tensors lie on the card, as it means
    the Pallas kernel on any device but a CPU in the JAX package; on the
    CPU both take the kernel's plain version."""
    return F.conv2d if cfg.pallas_conv == "off" else make_conv_fn()


def build_model(cfg: ModelConfig) -> nn.Module:
    """An fp32 module in eval mode; ``set_compute_dtype`` casts it."""
    for field, choices in _MODE_CHOICES.items():
        val = getattr(cfg, field, choices[0])
        if val not in choices:
            raise ValueError(f"model.{field}={val!r}: expected one of "
                             f"{choices}")
    if cfg.architecture in NOT_PORTED:
        raise NotImplementedError(
            f"model.architecture={cfg.architecture!r} is not ported yet "
            "(ROADMAP.md Queue A item 13, other architectures)")
    if cfg.architecture not in ("UNetResNet", "SaltUNet", "SaltLinkNet"):
        raise KeyError(f"unknown architecture {cfg.architecture!r}")
    if cfg.quant_bits:
        raise NotImplementedError("model.quant_bits: int8 serving is not "
                                  "ported yet (ROADMAP.md Queue A item 15)")
    if cfg.architecture == "SaltUNet":
        from salt_tpu_torch.models.salt_unet import SaltUNet
        return SaltUNet(num_classes=cfg.num_classes, n_filters=cfg.n_filters,
                        conv_kernel=cfg.conv_kernel,
                        repeat_blocks=cfg.repeat_blocks,
                        dropout_2d=cfg.dropout_2d).eval()
    if cfg.architecture == "SaltLinkNet":
        from salt_tpu_torch.models.salt_unet import SaltLinkNet
        return SaltLinkNet(num_classes=cfg.num_classes,
                           n_filters=cfg.n_filters,
                           repeat_blocks=cfg.repeat_blocks).eval()
    from salt_tpu_torch.models.unet import UNetResNet
    model = UNetResNet(encoder_depth=cfg.encoder_depth or 34,
                       num_classes=cfg.num_classes,
                       use_hypercolumn=cfg.use_hypercolumn, pool0=cfg.pool0,
                       pad_mode=cfg.conv_pad_mode,
                       upsample_mode=cfg.upsample_mode,
                       dropout_2d=cfg.dropout_2d,
                       hypercolumn_impl=cfg.hypercolumn_impl,
                       decoder_impl=cfg.decoder_impl,
                       infer_conv=infer_conv_fn(cfg))
    return model.eval()


@torch.no_grad()
def init_seeded(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and BN statistic from ``numpy`` seed ``seed``:
    conv/linear weights N(0, 1/fan_in), biases 0.05 N(0, 1), BN scale and
    variance U(0.8, 1.2), BN shift and mean 0.1 N(0, 1)."""
    rng = np.random.RandomState(seed)

    def fill(t: torch.Tensor, values: np.ndarray):
        t.copy_(torch.from_numpy(values.astype(np.float32)))

    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            w = module.weight
            fan_in = int(np.prod(w.shape[1:]))
            fill(w, rng.randn(*w.shape) / np.sqrt(fan_in))
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
    shift 0, mean 0, variance 1. The distribution of the JAX package's
    init, not its bits."""
    g = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            w = module.weight
            fan_in = int(np.prod(w.shape[1:]))
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=g)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.BatchNorm2d):
            module.reset_parameters()
    return model
