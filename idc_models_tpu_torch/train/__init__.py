"""Training: losses, metrics, the optimizer, the steps and the loops."""
