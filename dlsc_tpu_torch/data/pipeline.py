"""Batch-level preprocessing on the device.

Counterpart of ``dlsc_tpu/data/pipeline.py`` for ``mode="ast"``:

- eval: PCM16 → float, then log-mel (kernel K1 on the card) → dB →
  per-clip renorm;
- train: the same features, then SpecAugment, then Mixup when enabled,
  with one-hot labels mixed into soft labels.

The train path's random numbers are drawn on the host by ``draw`` from an
explicit ``numpy.random.Generator`` and handed to ``train_batch``, so that a
test can give both packages the same draws. The other modes (envnet_v2,
cnn_esc50, raw) are not ported yet (ROADMAP §1 M7).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from dlsc_tpu_torch.ops import augment as A
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
    time_mask: int = 192     # max time-mask length (frames); 0 = off
    freq_mask: int = 48      # max frequency-mask length (mel bands); 0 = off
    enable_mixup: bool = False
    mixup_alpha: float = 0.5

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

    def draw(self, batch: int, num_samples: int, rng: np.random.Generator) -> "TrainDraws":
        """The random vectors of one train batch of ``batch`` clips of
        ``num_samples`` samples: SpecAugment's, then Mixup's when enabled."""
        cfg = self.cfg
        spec = A.spec_augment_draws(batch, cfg.n_mels, cfg.mel_config().num_frames(num_samples),
                                    cfg.time_mask, cfg.freq_mask, rng)
        mix = A.mixup_draws(batch, cfg.mixup_alpha, rng) if cfg.enable_mixup else None
        return TrainDraws(spec, mix)

    @torch.no_grad()
    def train_batch(self, wave: torch.Tensor, labels: torch.Tensor,
                    draws: "TrainDraws") -> tuple[torch.Tensor, torch.Tensor]:
        """(features (B, n_mels, n_frames) f32, soft labels (B, C) f32), on
        the waveform's device, outside the autograd graph (the JAX step's
        ``stop_gradient``)."""
        if (draws.mix is not None) != self.cfg.enable_mixup:
            raise ValueError("draws do not match enable_mixup: make them with "
                             "this pipeline's draw()")
        dev = wave.device
        x = A.spec_augment(self.eval_batch(wave), draws.spec.to(dev))
        y = A.one_hot(labels.to(dev), self.cfg.num_classes)
        if draws.mix is not None:
            x, y = A.mixup(x, y, draws.mix.to(dev))
        return x, y


@dataclasses.dataclass(frozen=True)
class TrainDraws:
    """The random vectors of one train batch (see ``DevicePipeline.draw``)."""

    spec: A.SpecAugmentDraws
    mix: A.MixupDraws | None


def pipeline_from_dataset_config(ds: dict[str, Any]) -> DevicePipeline:
    """Build from the merged dataset+overrides dict the scripts assemble."""
    pc = ds.get("preprocessing_config") or {}
    aug = ds.get("augment") or {}
    tm, fm = aug.get("time_mask", False), aug.get("freq_mask", False)
    for name, v in (("time_mask", tm), ("freq_mask", fm)):
        if v is True:  # int(True) == 1 would silently neuter SpecAugment
            raise ValueError(
                f"augment.{name} must be false or a max mask length (int), "
                f"got true — e.g. time_mask: 192, freq_mask: 48")
    cfg = PipelineConfig(
        mode=ds.get("preprocessing_mode", "raw"),
        num_classes=int(ds.get("num_classes", 50)),
        sample_rate=int(pc.get("sample_rate", ds.get("sample_rate", 44_100))),
        n_mels=int(pc.get("n_mels", 128)),
        normalize=bool(pc.get("normalize", True)),
        target_mean=float(pc.get("target_mean", 0.0)),
        target_std=float(pc.get("target_std", 0.5)),
        time_mask=int(tm) if tm else 0,
        freq_mask=int(fm) if fm else 0,
        enable_mixup=bool(ds.get("enable_mixup", False)),
        mixup_alpha=float(ds.get("mixup_alpha", 0.5)),
    )
    return DevicePipeline(cfg)
