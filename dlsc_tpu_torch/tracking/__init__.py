"""Experiment tracking (file-based MLflow replacement)."""

from dlsc_tpu_torch.tracking.tracker import Tracker

__all__ = ["Tracker"]
