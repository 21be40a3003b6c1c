"""Losses: the Lovász hinge (through the sort kernel), Lovász-Softmax,
stable BCE, and the loss registry."""
