"""Batch-level eval preprocessing on the device.

Counterpart of ``dlsc_tpu/data/pipeline.py``, eval path of ``mode="ast"``:
PCM16 → float, then log-mel (kernel K1 on the card) → dB → per-clip renorm.
The train path (SpecAugment, Mixup) and the other modes are not ported yet
(ROADMAP §1: M2 for AST augmentation, M7 for envnet_v2 / cnn_esc50 / raw).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from dlsc_tpu_torch.ops import mel as M
from dlsc_tpu_torch.ops.mel_kernel import log_mel


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    mode: str = "ast"
    num_classes: int = 50
    sample_rate: int = 44_100
    n_mels: int = 128
    normalize: bool = True
    target_mean: float = 0.0
    target_std: float = 0.5

    def mel_config(self) -> M.MelConfig:
        return M.MelConfig(sample_rate=self.sample_rate, n_mels=self.n_mels)


class DevicePipeline:
    """(B, T) waveform batch → model inputs, on the waveform's device."""

    def __init__(self, cfg: PipelineConfig):
        if cfg.mode != "ast":
            raise NotImplementedError(
                f"preprocessing_mode {cfg.mode!r} is not ported yet (ROADMAP "
                "§1 M7: envnet_v2, cnn_esc50 and raw pipelines)")
        self.cfg = cfg

    @staticmethod
    def _to_float(wave: torch.Tensor) -> torch.Tensor:
        """PCM16 wire format → float."""
        if not wave.dtype.is_floating_point:
            return wave.float() / 32768.0
        return wave.float()

    def eval_batch(self, wave: torch.Tensor) -> torch.Tensor:
        """No augmentation: AST features (B, n_mels, n_frames) f32."""
        cfg = self.cfg
        feats = log_mel(self._to_float(wave), cfg.mel_config())
        if cfg.normalize:
            feats = M.ast_normalize(feats, cfg.target_mean, cfg.target_std)
        return feats


def pipeline_from_dataset_config(ds: dict[str, Any]) -> DevicePipeline:
    """Build from the merged dataset+overrides dict the scripts assemble."""
    pc = ds.get("preprocessing_config") or {}
    cfg = PipelineConfig(
        mode=ds.get("preprocessing_mode", "raw"),
        num_classes=int(ds.get("num_classes", 50)),
        sample_rate=int(pc.get("sample_rate", ds.get("sample_rate", 44_100))),
        n_mels=int(pc.get("n_mels", 128)),
        normalize=bool(pc.get("normalize", True)),
        target_mean=float(pc.get("target_mean", 0.0)),
        target_std=float(pc.get("target_std", 0.5)),
    )
    return DevicePipeline(cfg)
