"""UrbanSound8K datamodule (re-export; implementation in datamodule.py)."""

from dlsc_tpu_torch.data.datamodule import US8KDataModule

__all__ = ["US8KDataModule"]
