"""Training: losses, optimizers, metrics, state and the train/eval steps."""
