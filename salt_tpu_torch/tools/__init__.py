"""Measurement harnesses of the port: the conv and matmul probes and the
conv kernel's A/B in the flagship TTA step (``python -m
salt_tpu_torch.tools.conv_probe``, ``conv_probe2``, ``ab_conv``), the
kernels' A/Bs against variants of their sources, the bench (``bench``),
the distillation curve (``distill_curve``) and the profiler reading they
share (``profiling``). Each runs on the
card unless given ``--device cpu`` and does nothing at import."""
