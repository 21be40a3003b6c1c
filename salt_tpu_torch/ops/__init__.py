"""Preprocessing (plain torch and the CUDA kernel), TTA, RLE, kernel build."""
