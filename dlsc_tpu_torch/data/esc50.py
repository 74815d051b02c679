"""ESC-50 datamodule (re-export; implementation in datamodule.py)."""

from dlsc_tpu_torch.data.datamodule import ESC50DataModule

__all__ = ["ESC50DataModule"]
