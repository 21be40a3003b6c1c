"""Int8 convolutions for the infer form: ``model.quant_bits=8``
(counterpart of ``salt_tpu/models/quant.py`` ``make_conv_fn`` :24-34,
AQT's ``conv_general_dilated``).

:func:`make_conv_fn` returns an ``F.conv2d``-compatible callable that
quantizes both operands of every call, as AQT's dynamic quantization
does, and runs the int8 conv (``ops.int8_conv``: the quantize and conv
kernels on the card, their plain versions on the CPU). It computes in
the input's dtype, or under ``torch.autocast`` in the autocast dtype that
``F.conv2d`` would cast to (so validation during ``fit`` quantizes the
bf16 operands, as the JAX package's bf16 flax convs hand AQT bf16); a
bias is added after, in that dtype, as flax adds it. Nothing is cached:
the weights are quantized anew on every call, so an optimizer step can
never leave a stale int8 copy behind.

Which convs it reaches is the registry's business
(``registry.infer_conv_fn``): the infer form's conv callable of the
U-Nets and the depth net, which is the JAX package's route
(``salt_tpu/models/registry.py:35-52``): the encoders' convs
(``salt_tpu/models/encoders.py``), the ConvBnRelu and sliced-concat
convs of the center, the decoders and ``final_conv`` (each branch of a
sliced-concat sum quantized on its own, with its slice of the weight);
and, beyond the JAX package's route, every ConvBnRelu conv of the
scratch nets (``models/salt_unet.py``). The SE gates, the dense layers
and the fp32 heads stay in full precision. The train form never
quantizes.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from salt_tpu_torch.ops.int8_conv import conv2d_int8

#: the widths the port quantizes to
BITS = (8,)


def make_conv_fn(bits: Optional[int]) -> Optional[Callable[..., torch.Tensor]]:
    """The int8 conv callable for ``bits`` 8, None for 0 (full
    precision); any other width raises ``ValueError``."""
    if not bits:
        return None
    if bits not in BITS:
        raise ValueError(f"model.quant_bits={bits}: the port quantizes to "
                         f"{BITS} bits (or 0, full precision)")

    def conv_fn(x, weight, bias=None, stride=1, padding=0, dilation=1,
                groups=1):
        if dilation not in (1, (1, 1), [1, 1]):
            raise ValueError(f"int8 conv: dilation {dilation}")
        dtype = (torch.get_autocast_dtype(x.device.type)
                 if torch.is_autocast_enabled(x.device.type) else x.dtype)
        y = conv2d_int8(x.to(dtype), weight.to(dtype), stride, padding,
                        groups)
        if bias is not None:
            y = y + bias.to(dtype)[None, :, None, None]
        return y

    return conv_fn
