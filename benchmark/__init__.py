"""The benchmark of the PyTorch and CUDA port (``salt_tpu_torch``): see
``benchmark/README.md``."""
