"""Kernel K1: fused STFT→power→mel on the card (``csrc/mel_power.cu``).

Counterpart of ``dlsc_tpu/ops/mel_pallas.py``. ``mel_power`` launches the
CUDA kernel for a CUDA tensor and takes the plain version,
``ops.mel.mel_spectrogram``, for a CPU tensor; it never falls back from one
to the other. dB and the AST renorm are plain torch epilogues, as they are
XLA epilogues around the TPU kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dlsc_tpu_torch import _kernels
from dlsc_tpu_torch.ops import mel as M

_SLAB = 32      # the kernel walks frame samples 32 at a time
_N_MELS = 128   # the kernel's mel-band count

launches = 0    # kernel launches since the last reset (see reset_launches)


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    lib = _kernels.load("mel_power")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dlsc_mel_power.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.dlsc_mel_power.restype = i
    return lib


@functools.lru_cache(maxsize=8)
def dft_mel_constants(cfg: M.MelConfig) -> tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """(lo, cos_w, sin_w, fb) in f32 for the kernel.

    ``cos_w``/``sin_w`` are the Hann-windowed DFT matrices for bins
    1..n_fft/2, cut to rows ``lo .. lo + L`` that hold the window's support
    (rounded out to the kernel's 32-row slab); the rows dropped are exactly
    zero. ``fb`` is the filterbank without its all-zero DC row.
    """
    n_fft = cfg.n_fft
    win = M.hann_window_np(cfg.win_length, n_fft)
    nz = np.nonzero(win)[0]
    lo = int(nz[0]) // _SLAB * _SLAB
    hi = min(-(-(int(nz[-1]) + 1) // _SLAB) * _SLAB, n_fft)
    if (hi - lo) % _SLAB:
        raise ValueError(f"n_fft {n_fft} must be a multiple of {_SLAB}")
    k = np.arange(1, n_fft // 2 + 1, dtype=np.float64)
    n = np.arange(lo, hi, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft               # (L, n_fft//2)
    cos_w = (win[lo:hi, None] * np.cos(ang)).astype(np.float32)
    sin_w = (win[lo:hi, None] * np.sin(ang)).astype(np.float32)
    fb = M.mel_filterbank_np(cfg)
    if np.abs(fb[0]).max() != 0.0:
        raise ValueError("the DC bin must carry zero mel weight")
    return lo, cos_w, sin_w, np.ascontiguousarray(fb[1:])


@functools.lru_cache(maxsize=16)
def _device_constants(cfg: M.MelConfig, device: torch.device):
    lo, cos_w, sin_w, fb = dft_mel_constants(cfg)
    return lo, *(torch.from_numpy(a).to(device) for a in (cos_w, sin_w, fb))


def mel_power(wave: torch.Tensor, cfg: M.MelConfig = M.MelConfig()) -> torch.Tensor:
    """Mel power spectrogram: (B, T) f32 → (B, n_mels, n_frames) f32.

    CUDA tensor: kernel K1. CPU tensor: ``ops.mel.mel_spectrogram``.
    """
    if wave.device.type == "cpu":
        return M.mel_spectrogram(wave, cfg)
    if wave.device.type != "cuda":
        raise ValueError(f"mel_power: unsupported device {wave.device}")
    if wave.ndim != 2 or wave.dtype != torch.float32:
        raise ValueError(
            f"mel_power: want a (B, T) float32 waveform, got {tuple(wave.shape)} "
            f"{wave.dtype}")
    if cfg.n_mels != _N_MELS:
        raise ValueError(f"mel_power: the kernel computes {_N_MELS} mel bands, "
                         f"not {cfg.n_mels}")
    B, T = wave.shape
    pad = cfg.n_fft // 2
    if T <= pad:
        raise ValueError(f"mel_power: reflect padding needs T > {pad}, got {T}")
    # center=True reflect pad in torch, as the TPU kernel's caller does
    padded = torch.nn.functional.pad(wave[:, None], (pad, pad), mode="reflect")[:, 0]
    padded = padded.contiguous()
    n_frames = cfg.num_frames(T)
    lo, cos_w, sin_w, fb = _device_constants(cfg, wave.device)
    out = torch.empty((B, cfg.n_mels, n_frames), dtype=torch.float32,
                      device=wave.device)
    lib = _lib()
    with torch.cuda.device(wave.device):
        err = lib.dlsc_mel_power(
            padded.data_ptr(), cos_w.data_ptr(), sin_w.data_ptr(), fb.data_ptr(),
            out.data_ptr(), B, padded.shape[1], lo, cfg.hop_length,
            cos_w.shape[0], cos_w.shape[1], cfg.n_mels, n_frames,
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(lib, err, "mel_power kernel")
    global launches
    launches += 1
    return out


def log_mel(wave: torch.Tensor, cfg: M.MelConfig = M.MelConfig()) -> torch.Tensor:
    """Log-mel (dB) through ``mel_power``."""
    return M.amplitude_to_db(mel_power(wave, cfg), cfg.top_db)


def ast_features(wave: torch.Tensor, cfg: M.MelConfig = M.MelConfig(),
                 target_mean: float = 0.0, target_std: float = 0.5) -> torch.Tensor:
    """AST features through ``mel_power``: log-mel → per-clip renorm."""
    return M.ast_normalize(log_mel(wave, cfg), target_mean, target_std)
