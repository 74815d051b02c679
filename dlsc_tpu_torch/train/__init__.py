"""Training: losses, optimizers, metrics, state, the train/eval steps,
checkpoints and the Trainer (``loop.py``)."""
