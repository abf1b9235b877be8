"""Training: optimizer, checkpoints and the loop."""
