"""Batch-level preprocessing on the device, one path per ``preprocessing_mode``.

Counterpart of ``dlsc_tpu/data/pipeline.py``:

- ``ast``: PCM16 → float, log-mel (kernel K1 on the card, 1024/160/400) →
  dB → per-clip renorm; train adds SpecAugment, then Mixup when enabled;
- ``envnet_v2`` (EnvNet-v2 and LEAF): zero-pad ``padding_ratio`` x window
  on each side, then a random crop (train), the centre crop (eval) or
  ``test_crops`` evenly spaced crops (eval with ``multi_crop_test``:
  (B, n_crops, window)); train adds the optional time stretch and gain
  shift, and BC mixing when enabled;
- ``cnn_esc50``: log-mel at 1024/512/1024 (kernel K1 on the card) → dB →
  the bilinear, antialiased resize to 224 x 224 of ``jax.image.resize``
  (two small weight matrices, ``resize_matrix_np``) → /0.5; train adds random
  flips and a translation of up to 10%;
- ``raw``: the waveform as float.

The train path's random numbers are drawn on the host by ``draw`` from an
explicit ``numpy.random.Generator`` and handed to ``train_batch``, so that a
test can give both packages the same draws. Labels go one-hot, and soft
where a mix changes them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from dlsc_tpu_torch.ops import augment as A
from dlsc_tpu_torch.ops import mel as M
from dlsc_tpu_torch.ops.mel_kernel import log_mel

MODES = ("ast", "envnet_v2", "cnn_esc50", "raw")
CNN_IMAGE = 224          # the CNN's square input, pixels
CNN_TRANSLATE = 0.1      # the CNN's largest shift, a share of each side


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    mode: str = "ast"
    num_classes: int = 50
    sample_rate: int = 44_100
    # envnet_v2 (and LEAF)
    window_length: float = 5.0     # seconds
    padding_ratio: float = 0.5     # zero padding on each side, a share of the window
    multi_crop_test: bool = False
    test_crops: int = 10
    time_stretch: tuple[float, float] | None = None   # factor range
    gain_shift: tuple[float, float] | None = None     # dB range
    enable_bc_mixing: bool = False
    # ast
    n_mels: int = 128
    normalize: bool = True
    target_mean: float = 0.0
    target_std: float = 0.5
    time_mask: int = 192     # max time-mask length (frames); 0 = off
    freq_mask: int = 48      # max frequency-mask length (mel bands); 0 = off
    enable_mixup: bool = False
    mixup_alpha: float = 0.5

    @property
    def window_samples(self) -> int:
        return int(self.window_length * self.sample_rate)

    @property
    def padding_samples(self) -> int:
        return int(self.window_samples * self.padding_ratio)

    def mel_config(self) -> M.MelConfig:
        return M.MelConfig(sample_rate=self.sample_rate, n_mels=self.n_mels)

    def cnn_mel_config(self) -> M.MelConfig:
        return M.MelConfig(sample_rate=self.sample_rate, n_fft=1024, hop_length=512,
                           win_length=1024, n_mels=self.n_mels)


@functools.lru_cache(maxsize=8)
def resize_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) f32 weights of ``jax.image.resize``'s bilinear
    method along one axis: the triangle kernel, widened by in/out when
    shrinking (the antialiasing), each output's weights normalised to sum
    to 1, and zero for an output whose sample point lies outside the input.
    Computed in f32, as ``jax.image.scale_and_translate`` computes it."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))   # a Python float there, then f32
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).T.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _resize_matrix(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """``resize_matrix_np`` on ``device`` once, so that a call copies nothing
    from the host (a CUDA graph can hold it)."""
    return torch.from_numpy(resize_matrix_np(in_size, out_size)).to(device)


def resize_bilinear(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``jax.image.resize(img, (B, height, width), "bilinear")``: (B, h, w) →
    (B, height, width), as Wh @ img @ Wwᵀ."""
    _, h, w = img.shape
    if h != height:
        img = torch.matmul(_resize_matrix(h, height, img.device), img)
    if w != width:
        img = torch.matmul(img, _resize_matrix(w, width, img.device).T)
    return img


@dataclasses.dataclass(frozen=True)
class TrainDraws:
    """The random vectors of one AST train batch (see ``DevicePipeline.draw``)."""

    spec: A.SpecAugmentDraws
    mix: A.MixupDraws | None


@dataclasses.dataclass(frozen=True)
class WaveDraws:
    """The random vectors of one ``envnet_v2`` train batch: the crop starts
    into the padded clip, and the stretch, gain and BC draws of the
    augmentations the pipeline enables (None for the others)."""

    crop: torch.Tensor
    stretch: A.GatedDraws | None
    gain: A.GatedDraws | None
    bc: A.BCDraws | None


class DevicePipeline:
    """(B, T) waveform batch → model inputs, on the waveform's device."""

    def __init__(self, cfg: PipelineConfig):
        if cfg.mode not in MODES:
            raise ValueError(f"Unknown preprocessing_mode {cfg.mode!r}; known: {MODES}")
        self.cfg = cfg

    @property
    def multi_crop(self) -> bool:
        """Whether ``eval_batch`` returns (B, n_crops, window) crops."""
        return self.cfg.mode == "envnet_v2" and self.cfg.multi_crop_test

    @staticmethod
    def _to_float(wave: torch.Tensor) -> torch.Tensor:
        """PCM16 wire format → float."""
        if not wave.dtype.is_floating_point:
            return wave.float() / 32768.0
        return wave.float()

    def _padded(self, wave: torch.Tensor) -> torch.Tensor:
        p = self.cfg.padding_samples
        return torch.nn.functional.pad(wave, (p, p))

    def _cnn_features(self, wave: torch.Tensor) -> torch.Tensor:
        img = resize_bilinear(log_mel(wave, self.cfg.cnn_mel_config()), CNN_IMAGE, CNN_IMAGE)
        return img / 0.5   # Normalize(mean=0, std=0.5)

    def eval_batch(self, wave: torch.Tensor) -> torch.Tensor:
        """No augmentation: AST features (B, n_mels, n_frames); the centre
        crop (B, window) or the crops (B, n_crops, window) for envnet_v2;
        CNN images (B, 224, 224); the float wave for raw. f32."""
        cfg = self.cfg
        wave = self._to_float(wave)
        if cfg.mode == "ast":
            feats = log_mel(wave, cfg.mel_config())
            if cfg.normalize:
                feats = M.ast_normalize(feats, cfg.target_mean, cfg.target_std)
            return feats
        if cfg.mode == "envnet_v2":
            x = self._padded(wave)
            if cfg.multi_crop_test:
                return A.multi_crop(x, cfg.window_samples, cfg.test_crops)
            return A.center_crop(x, cfg.window_samples)
        if cfg.mode == "cnn_esc50":
            return self._cnn_features(wave)
        return wave

    def forward_eval(self, model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
        """``model``'s outputs on ``eval_batch``'s ``x``: for multi-crop
        inputs the mean over each clip's crops of the per-crop outputs (the
        reference's mean over stacked crop logits)."""
        if self.multi_crop and x.ndim == 3:
            B, n, W = x.shape
            return model(x.reshape(B * n, W)).reshape(B, n, -1).mean(dim=1)
        return model(x)

    def draw(self, batch: int, num_samples: int, rng: np.random.Generator):
        """The random vectors of one train batch of ``batch`` clips of
        ``num_samples`` samples, in the mode's form: ``TrainDraws`` (ast;
        SpecAugment's, then Mixup's when enabled), ``WaveDraws``
        (envnet_v2), ``FlipDraws`` (cnn_esc50), None (raw)."""
        cfg = self.cfg
        if cfg.mode == "ast":
            spec = A.spec_augment_draws(batch, cfg.n_mels,
                                        cfg.mel_config().num_frames(num_samples),
                                        cfg.time_mask, cfg.freq_mask, rng)
            mix = A.mixup_draws(batch, cfg.mixup_alpha, rng) if cfg.enable_mixup else None
            return TrainDraws(spec, mix)
        if cfg.mode == "envnet_v2":
            crop = A.crop_draws(batch, num_samples + 2 * cfg.padding_samples,
                                cfg.window_samples, rng)
            stretch = (A.gated_draws(batch, *cfg.time_stretch, rng)
                       if cfg.time_stretch is not None else None)
            gain = (A.gated_draws(batch, *cfg.gain_shift, rng)
                    if cfg.gain_shift is not None else None)
            bc = A.bc_draws(batch, rng) if cfg.enable_bc_mixing else None
            return WaveDraws(crop, stretch, gain, bc)
        if cfg.mode == "cnn_esc50":
            return A.flip_draws(batch, CNN_IMAGE, CNN_IMAGE, rng, CNN_TRANSLATE)
        return None

    def _check_draws(self, draws) -> None:
        cfg = self.cfg
        if cfg.mode == "ast":
            if not isinstance(draws, TrainDraws) or (draws.mix is not None) != cfg.enable_mixup:
                raise ValueError("draws do not match enable_mixup: make them with "
                                 "this pipeline's draw()")
        elif cfg.mode == "envnet_v2":
            if not isinstance(draws, WaveDraws) or (
                    (draws.stretch is not None) != (cfg.time_stretch is not None)
                    or (draws.gain is not None) != (cfg.gain_shift is not None)
                    or (draws.bc is not None) != cfg.enable_bc_mixing):
                raise ValueError("draws do not match time_stretch, gain_shift and "
                                 "enable_bc_mixing: make them with this pipeline's draw()")
        elif cfg.mode == "cnn_esc50" and not isinstance(draws, A.FlipDraws):
            raise ValueError("cnn_esc50 takes FlipDraws: make them with this pipeline's draw()")

    @torch.no_grad()
    def train_batch(self, wave: torch.Tensor, labels: torch.Tensor,
                    draws) -> tuple[torch.Tensor, torch.Tensor]:
        """(model inputs f32, soft labels (B, C) f32), on the waveform's
        device, outside the autograd graph (the JAX step's
        ``stop_gradient``)."""
        cfg = self.cfg
        self._check_draws(draws)
        dev = wave.device
        y = A.one_hot(labels.to(dev), cfg.num_classes)
        if cfg.mode == "ast":
            x = A.spec_augment(self.eval_batch(wave), draws.spec.to(dev))
            if draws.mix is not None:
                x, y = A.mixup(x, y, draws.mix.to(dev))
            return x, y
        if cfg.mode == "envnet_v2":
            x = A.random_crop(self._padded(self._to_float(wave)), draws.crop,
                              cfg.window_samples)
            if draws.stretch is not None:
                x = A.time_stretch(x, draws.stretch)
            if draws.gain is not None:
                x = A.gain_shift(x, draws.gain)
            if draws.bc is not None:
                x, y = A.bc_mix(x, y, draws.bc)
            return x, y
        if cfg.mode == "cnn_esc50":
            return A.image_flip_translate(self._cnn_features(self._to_float(wave)), draws), y
        return self._to_float(wave), y


def _pair(v) -> tuple[float, float] | None:
    return tuple(v) if isinstance(v, (list, tuple)) else None


def pipeline_from_dataset_config(ds: dict[str, Any]) -> DevicePipeline:
    """Build from the merged dataset+overrides dict the scripts assemble."""
    pc = ds.get("preprocessing_config") or {}
    aug = ds.get("augment") or {}
    wave_aug = pc.get("augment") or {}
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
        window_length=float(pc.get("window_length", 5.0)),
        padding_ratio=float(pc.get("padding_ratio", 0.5)),
        multi_crop_test=bool(pc.get("multi_crop_test", False)),
        test_crops=int(pc.get("test_crops", 10)),
        time_stretch=_pair(wave_aug.get("time_stretch")),
        gain_shift=_pair(wave_aug.get("gain_shift")),
        enable_bc_mixing=bool(ds.get("enable_bc_mixing", False)),
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
