"""Config tree, logging, checkpoints and device selection."""
