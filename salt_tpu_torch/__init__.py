"""salt_tpu_torch — the PyTorch / CUDA port of ``salt_tpu`` for one NVIDIA
H100 (Hopper, sm_90a).

The layout mirrors ``salt_tpu`` so each module's counterpart is found
under the same name:

- ``salt_tpu_torch.core``      config tree (own copy), logging, the
                               experiment store and flat-npz checkpoints,
                               device selection
- ``salt_tpu_torch.data``      PNG pack decoding, synthetic data, bundles,
                               K-fold split, batch feed, auxiliary crops,
                               dataset statistics, the integrity checks
- ``salt_tpu_torch.ops``       preprocessing (plain torch + the CUDA kernel),
                               augmentation, the bitonic sort (plain torch +
                               the CUDA kernel), the int8 quantize and conv
                               (plain torch + CUDA kernels), TTA, RLE and
                               COCO RLE codecs, kernel build
- ``salt_tpu_torch.losses``    the Lovász hinge / softmax, stable BCE, dice
                               and the mixed dice losses, the focal loss
- ``salt_tpu_torch.metrics``   IoU / IOUT, ROC-AUC
- ``salt_tpu_torch.models``    the U-Net (ResNet 18-152, SE-ResNet,
                               SE-ResNeXt or DenseNet encoder, scSE decoder,
                               hypercolumn head), the depth-gated U-Net, the
                               scratch SaltUNet and SaltLinkNet,
                               LargeKernelMatters, PSPNet, the stacking heads,
                               the emptiness classifier, the int8 convs of
                               ``model.quant_bits``, the flax-checkpoint
                               bridge and the pretrained encoder import
- ``salt_tpu_torch.train``     ``SegmentationRunner`` (train, eval and predict
                               steps) and its classifier, stacking and
                               distillation runners, train state, callbacks,
                               the fit loops, the throughput probes
- ``salt_tpu_torch.pipeline``  the ``train``, CV and ``serve`` entry points,
                               the int8 quality gate, the emptiness and
                               stacking CVs, ``full-solution``, ensembling,
                               distillation, the analysis and preview
                               reports
- ``salt_tpu_torch.tools``     the probes, A/Bs, the bench and the profiler
                               reading

The package imports torch, numpy, pandas, PIL and yaml, never jax, flax or
anything of ``salt_tpu``. Entry points run on ``device="cuda"`` unless the
caller asks for the CPU.
"""

__version__ = "0.1.0"
