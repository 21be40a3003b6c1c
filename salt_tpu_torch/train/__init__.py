"""Inference steps (``SegmentationRunner``)."""
