"""salt_tpu_torch — the PyTorch / CUDA port of ``salt_tpu`` for one NVIDIA
H100 (Hopper, sm_90a).

The layout mirrors ``salt_tpu`` so each module's counterpart is found
under the same name:

- ``salt_tpu_torch.core``      config tree (own copy), logging, flat-npz
                               checkpoints, device selection
- ``salt_tpu_torch.data``      PNG pack decoding
- ``salt_tpu_torch.ops``       preprocessing (plain torch + the CUDA kernel),
                               TTA, RLE codec, kernel build
- ``salt_tpu_torch.models``    UNetResNet (ResNet 18/34 encoder, scSE decoder,
                               hypercolumn head) and the flax-checkpoint bridge
- ``salt_tpu_torch.train``     the inference half of ``SegmentationRunner``
- ``salt_tpu_torch.pipeline``  the ``serve`` entry point

The package imports torch, numpy, pandas, PIL and yaml, never jax, flax or
anything of ``salt_tpu``. Entry points run on ``device="cuda"`` unless the
caller asks for the CPU.
"""

__version__ = "0.1.0"
