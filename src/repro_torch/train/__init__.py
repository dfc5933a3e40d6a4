"""Training: optimizers, the step, checkpoints and the loop."""
