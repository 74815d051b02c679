"""Plain AST features: log-mel (torchaudio ``MelSpectrogram`` semantics:
periodic Hann window of 400 centred in a 1024-point FFT, hop 160, reflect
centre padding, power 2, the HTK mel filterbank without area norm; then
``AmplitudeToDB`` with the per-clip 80-dB floor) and the per-clip renorm to
mean 0, std 0.5 (ddof 1); SpecAugment (one time and one mel span zeroed a
clip) and Mixup (a gated convex mix with another clip, features and soft
labels alike).

The window and the filterbank are built in numpy in float64 and rounded to
float32, as torchaudio builds them; everything else is plain torch in f32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

N_FFT, HOP, WIN, N_MELS = 1024, 160, 400, 128


def hann(win: int = WIN, n_fft: int = N_FFT) -> np.ndarray:
    n = np.arange(win)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win))
    left = (n_fft - win) // 2
    return np.pad(w, (left, n_fft - win - left))


def mel_filterbank(sample_rate: int, n_fft: int = N_FFT, n_mels: int = N_MELS) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) triangles on the HTK mel scale, 0 .. sr/2."""
    def to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0, sample_rate // 2, n_fft // 2 + 1)
    f_pts = to_hz(np.linspace(to_mel(0.0), to_mel(sample_rate / 2.0), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def log_mel(wave: torch.Tensor, sample_rate: int, top_db: float = 80.0) -> torch.Tensor:
    """(B, T) f32 -> (B, 128, 1 + T // 160) dB mels."""
    pad = N_FFT // 2
    x = F.pad(wave.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)                                   # (B, frames, n_fft)
    w = torch.as_tensor(hann(), dtype=torch.float32, device=wave.device)
    spec = torch.fft.rfft(frames * w, n=N_FFT, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2                             # (B, frames, freqs)
    fb = torch.as_tensor(mel_filterbank(sample_rate), device=wave.device)
    mel = torch.matmul(power, fb).transpose(1, 2)                       # (B, mels, frames)
    db = 10.0 * torch.log10(mel.clamp_min(1e-10))
    return torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - top_db)


def renorm(x: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    mu = x.mean(dim=(1, 2), keepdim=True)
    n = x.shape[1] * x.shape[2]
    sd = torch.sqrt(((x - mu) ** 2).sum(dim=(1, 2), keepdim=True) / max(n - 1, 1))
    ok = sd > 0
    return torch.where(ok, (x - mu) / torch.where(ok, sd, torch.ones_like(sd)) * std + mean, x)


def features(wave: torch.Tensor, sample_rate: int, pipeline: dict, chunk: int = 32
             ) -> torch.Tensor:
    """The eval features of a batch of clips, ``chunk`` clips at a time."""
    out = []
    for a in range(0, wave.shape[0], chunk):
        x = log_mel(wave[a:a + chunk], sample_rate)
        if pipeline["normalize"]:
            x = renorm(x, pipeline["target_mean"], pipeline["target_std"])
        out.append(x)
    return torch.cat(out)


def augment(x: torch.Tensor, y: torch.Tensor, d) -> tuple[torch.Tensor, torch.Tensor]:
    """SpecAugment, then Mixup, with a batch's draws ``d`` (``inputs.Draws``)."""
    dev = x.device
    B, M, T = x.shape

    def span(start, length, n):
        i = torch.arange(n, device=dev)
        s = torch.as_tensor(start, device=dev)[:, None]
        return (i >= s) & (i < s + torch.as_tensor(length, device=dev)[:, None])

    x = x.masked_fill(span(d.t_start, d.t_len, T)[:, None, :]
                      | span(d.f_start, d.f_len, M)[:, :, None], 0.0)
    gate = torch.as_tensor(d.gate, device=dev)
    lam = torch.where(gate, torch.as_tensor(d.lam, device=dev), torch.ones(B, device=dev))
    partner = torch.as_tensor(d.partner, device=dev)
    x = lam[:, None, None] * x + (1 - lam[:, None, None]) * x[partner]
    y = lam[:, None] * y + (1 - lam[:, None]) * y[partner]
    return x, y
