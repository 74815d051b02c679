"""Log-mel and MFCC front-end in plain PyTorch (torchaudio semantics).

Counterpart of ``dlsc_tpu/ops/mel.py``: periodic Hann window centred in
``n_fft``, ``center=True`` reflect padding, one-sided spectrum to the
``power`` (2 by default), the mel filterbank on the HTK or Slaney scale with
Slaney's area norm optional (torchaudio ``melscale_fbanks``),
``AmplitudeToDB`` (``stype`` 'power' or 'amplitude') with the per-clip
``top_db`` clamp, the AST per-clip renorm, and ``mfcc`` (a DCT-II of the dB
mels, torchaudio ``MFCC``). The window, filterbank and DCT basis are built
in numpy, bit-identical to the reference's own numpy code.

This module is the plain version of kernel K1 (``ops/mel_kernel.py``): the
CPU path, and the oracle the kernel is checked against on the card. K1
computes the power-2 mel spectrum (any of the filterbanks); ``mfcc``, other
powers and ``stype`` are plain tensor functions here, as they are plain
``jnp`` there.
"""

from __future__ import annotations

import dataclasses
import functools
import math

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
    power: float = 2.0
    top_db: float | None = 80.0
    mel_scale: str = "htk"      # torchaudio MelSpectrogram default; or "slaney"
    mel_norm: str | None = None  # or "slaney" (area normalisation)

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


def _hz_to_mel(f, mel_scale: str = "htk") -> np.ndarray:
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)
    # slaney: linear below 1 kHz, logarithmic above
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, f / f_sp)


def _mel_to_hz(m, mel_scale: str = "htk") -> np.ndarray:
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    m * f_sp)


@functools.lru_cache(maxsize=16)
def mel_filterbank_np(cfg: MelConfig) -> np.ndarray:
    """Filterbank (n_freqs, n_mels) float32, torchaudio
    ``melscale_fbanks(norm=cfg.mel_norm, mel_scale=cfg.mel_scale)``."""
    f_max = cfg.f_max if cfg.f_max is not None else cfg.sample_rate / 2.0
    # torchaudio uses `sample_rate // 2` (integer) for the frequency axis top.
    all_freqs = np.linspace(0, cfg.sample_rate // 2, cfg.n_freqs)
    m_pts = np.linspace(_hz_to_mel(cfg.f_min, cfg.mel_scale),
                        _hz_to_mel(float(f_max), cfg.mel_scale), cfg.n_mels + 2)
    f_pts = _mel_to_hz(m_pts, cfg.mel_scale)
    f_diff = f_pts[1:] - f_pts[:-1]                      # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]         # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if cfg.mel_norm == "slaney":
        fb = fb * (2.0 / (f_pts[2:cfg.n_mels + 2] - f_pts[:cfg.n_mels]))[None, :]
    return fb.astype(np.float32)


def power_spectrogram(wave: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """One-sided |STFT| to ``cfg.power``: (B, T) → (B, n_freqs, n_frames) f32."""
    pad = cfg.n_fft // 2
    x = torch.nn.functional.pad(wave.float()[:, None], (pad, pad),
                                mode="reflect")[:, 0]
    frames = x.unfold(-1, cfg.n_fft, cfg.hop_length)     # (B, n_frames, n_fft)
    window = torch.as_tensor(hann_window_np(cfg.win_length, cfg.n_fft),
                             dtype=torch.float32, device=wave.device)
    spec = torch.fft.rfft(frames * window, n=cfg.n_fft, dim=-1)
    p = spec.real ** 2 + spec.imag ** 2 if cfg.power == 2.0 else spec.abs() ** cfg.power
    return p.transpose(-1, -2)


def mel_spectrogram(wave: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Mel power spectrogram: (B, T) → (B, n_mels, n_frames) f32."""
    p = power_spectrogram(wave, cfg)
    fb = torch.as_tensor(mel_filterbank_np(cfg), device=wave.device)
    return torch.einsum("bft,fm->bmt", p, fb)


def amplitude_to_db(x: torch.Tensor, top_db: float | None = 80.0,
                    stype: str = "power") -> torch.Tensor:
    """torchaudio ``AmplitudeToDB``: 10·log10(clamp(x, 1e-10)) for
    ``stype='power'``, 20·log10 for 'amplitude', with the top_db clamp taken
    per clip (max over the last two dims)."""
    multiplier = 10.0 if stype == "power" else 20.0
    x_db = multiplier * torch.log10(torch.clamp(x, min=_AMIN))
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


@functools.lru_cache(maxsize=8)
def _dct_matrix_np(n_mfcc: int, n_mels: int, norm: str | None) -> np.ndarray:
    """torchaudio ``create_dct``: DCT-II basis, (n_mels, n_mfcc) float32."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)[:, None]
    dct = np.cos(np.pi / n_mels * (n + 0.5) * k)  # (n_mfcc, n_mels)
    if norm is None:
        dct *= 2.0
    else:
        dct[0] *= 1.0 / math.sqrt(2.0)
        dct *= math.sqrt(2.0 / n_mels)
    return dct.T.astype(np.float32)


def mfcc(wave: torch.Tensor, cfg: MelConfig = MelConfig(), n_mfcc: int = 40,
         norm: str | None = "ortho", log_mels: bool = False) -> torch.Tensor:
    """MFCCs as ``torchaudio.transforms.MFCC``: the dB mels (no top_db) or,
    with ``log_mels``, log(mel + 1e-6), through the DCT-II (``norm``
    'ortho' or None): (B, T) → (B, n_mfcc, n_frames) f32."""
    mel = mel_spectrogram(wave, cfg)
    feats = torch.log(mel + 1e-6) if log_mels else amplitude_to_db(mel, top_db=None)
    dct = torch.as_tensor(_dct_matrix_np(n_mfcc, cfg.n_mels, norm), device=wave.device)
    return torch.einsum("bmt,mk->bkt", feats, dct)
