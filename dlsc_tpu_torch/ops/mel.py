"""Log-mel front-end in plain PyTorch (torchaudio semantics).

Counterpart of ``dlsc_tpu/ops/mel.py``: periodic Hann window centred in
``n_fft``, ``center=True`` reflect padding, one-sided power spectrum, HTK
mel filterbank, ``AmplitudeToDB(top_db=80)`` with the per-clip clamp, and
the AST per-clip renorm. The window and filterbank are built in numpy,
bit-identical to the reference's builders.

This module is the plain version of kernel K1 (``ops/mel_kernel.py``): the
CPU path, and the oracle the kernel is checked against on the card.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

AST_N_FFT = 1024
AST_HOP_LENGTH = 160
AST_WIN_LENGTH = 400
TARGET_SR = 44_100
_AMIN = 1e-10  # torchaudio AmplitudeToDB amin


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Static front-end configuration."""

    sample_rate: int = TARGET_SR
    n_fft: int = AST_N_FFT
    hop_length: int = AST_HOP_LENGTH
    win_length: int = AST_WIN_LENGTH
    n_mels: int = 128
    f_min: float = 0.0
    f_max: float | None = None  # defaults to sample_rate / 2
    top_db: float | None = 80.0

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        # center=True: padded length = T + 2*(n_fft//2); frames = 1 + T//hop
        return 1 + num_samples // self.hop_length


def hann_window_np(win_length: int, n_fft: int | None = None) -> np.ndarray:
    """Periodic Hann window (float64 numpy), center-padded to ``n_fft``."""
    n = np.arange(win_length)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    if n_fft is not None and n_fft != win_length:
        left = (n_fft - win_length) // 2
        w = np.pad(w, (left, n_fft - win_length - left))
    return w


def _hz_to_mel(f) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=16)
def mel_filterbank_np(cfg: MelConfig) -> np.ndarray:
    """HTK filterbank (n_freqs, n_mels) float32, torchaudio
    ``melscale_fbanks(norm=None, mel_scale="htk")``."""
    f_max = cfg.f_max if cfg.f_max is not None else cfg.sample_rate / 2.0
    # torchaudio uses `sample_rate // 2` (integer) for the frequency axis top.
    all_freqs = np.linspace(0, cfg.sample_rate // 2, cfg.n_freqs)
    m_pts = np.linspace(_hz_to_mel(cfg.f_min), _hz_to_mel(float(f_max)),
                        cfg.n_mels + 2)
    f_pts = _mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]                      # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]         # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def power_spectrogram(wave: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """One-sided power spectrogram: (B, T) → (B, n_freqs, n_frames) f32."""
    pad = cfg.n_fft // 2
    x = torch.nn.functional.pad(wave.float()[:, None], (pad, pad),
                                mode="reflect")[:, 0]
    frames = x.unfold(-1, cfg.n_fft, cfg.hop_length)     # (B, n_frames, n_fft)
    window = torch.as_tensor(hann_window_np(cfg.win_length, cfg.n_fft),
                             dtype=torch.float32, device=wave.device)
    spec = torch.fft.rfft(frames * window, n=cfg.n_fft, dim=-1)
    return (spec.real ** 2 + spec.imag ** 2).transpose(-1, -2)


def mel_spectrogram(wave: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Mel power spectrogram: (B, T) → (B, n_mels, n_frames) f32."""
    p = power_spectrogram(wave, cfg)
    fb = torch.as_tensor(mel_filterbank_np(cfg), device=wave.device)
    return torch.einsum("bft,fm->bmt", p, fb)


def amplitude_to_db(x: torch.Tensor, top_db: float | None = 80.0) -> torch.Tensor:
    """torchaudio ``AmplitudeToDB(stype="power")``: 10·log10(clamp(x, 1e-10))
    with the top_db clamp taken per clip (max over the last two dims)."""
    x_db = 10.0 * torch.log10(torch.clamp(x, min=_AMIN))
    if top_db is not None:
        ref = x_db.amax(dim=(-2, -1), keepdim=True)
        x_db = torch.maximum(x_db, ref - top_db)
    return x_db


def log_mel_spectrogram(wave: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """Log-mel (dB) features, (B, n_mels, n_frames)."""
    return amplitude_to_db(mel_spectrogram(wave, cfg), cfg.top_db)


def ast_normalize(log_mel: torch.Tensor, target_mean: float = 0.0,
                  target_std: float = 0.5) -> torch.Tensor:
    """Per-clip renorm to (target_mean, target_std) with the unbiased
    (ddof=1) std; a constant clip passes through unchanged."""
    mean = log_mel.mean(dim=(-2, -1), keepdim=True)
    n = log_mel.shape[-1] * log_mel.shape[-2]
    var = ((log_mel - mean) ** 2).sum(dim=(-2, -1), keepdim=True) / max(n - 1, 1)
    std = torch.sqrt(var)
    pos = std > 0
    normed = (log_mel - mean) / torch.where(pos, std, torch.ones_like(std))
    return torch.where(pos, normed * target_std + target_mean, log_mel)
