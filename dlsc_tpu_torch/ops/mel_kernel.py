"""Kernel K1: fused STFT→power→mel on the card (``csrc/mel_power.cu``).

Counterpart of ``dlsc_tpu/ops/mel_pallas.py``. ``mel_power`` launches the
CUDA kernel for a CUDA tensor and takes the plain version,
``ops.mel.mel_spectrogram``, for a CPU tensor; it never falls back from one
to the other. dB and the AST renorm are plain torch epilogues, as they are
XLA epilogues around the TPU kernel.

The kernel computes each frame's power spectrum by a real FFT in shared
memory (an n_fft/2-point complex Stockham FFT of the sample pairs, radix-8
passes then one radix-2 or -4 pass, ``_fft_passes``; then the split
post-pass) and the mel bands from the filterbank's sparse form; it reads the
clip itself and reflect-pads by index. ``fft_mel_constants`` gives it its
tables, ``_mel_plan`` its launch. It takes n_fft a power of two from 256 to
2048, any hop, win_length <= n_fft and 128 mel bands; anything else raises
``ValueError``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from dlsc_tpu_torch import _kernels
from dlsc_tpu_torch.ops import mel as M

_N_MELS = 128        # the kernel's mel-band count
_N_FFTS = (256, 512, 1024, 2048)
# csrc/mel_power.cu: threads a CTA, frames a CTA at most, staged samples at most
_THREADS, _FT_MAX, _SPAN_MAX = 256, 32, 16384

launches = 0    # kernel launches since the last reset (see reset_launches)


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    lib = _kernels.load("mel_power")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dlsc_mel_power.argtypes = [p] * 7 + [i] * 10 + [p]
    lib.dlsc_mel_power.restype = i
    return lib


def _check_config(cfg: M.MelConfig) -> None:
    if (cfg.n_fft not in _N_FFTS or not 1 <= cfg.win_length <= cfg.n_fft
            or cfg.hop_length < 1 or cfg.n_mels != _N_MELS or cfg.power != 2.0):
        raise ValueError(
            f"mel_power: the kernel takes n_fft in {_N_FFTS}, 1 <= win_length <= n_fft, "
            f"hop_length >= 1, n_mels {_N_MELS} and power 2; got {cfg}")


def _fft_passes(nc: int) -> list[int]:
    """The radices of the kernel's nc-point complex FFT, in order: radix 8
    while the sub-transform grows by 8 within nc, then 2 or 4."""
    passes, ns = [], 1
    while ns < nc:
        passes.append(min(8, nc // ns))
        ns *= passes[-1]
    return passes


def _pass_twiddles(nc: int) -> list[tuple[int, int, int]]:
    """(radix R, Ns, offset) of each pass after the first: the pass's
    twiddles e^(-2πi k r / (Ns R)), r = 1..R-1 slowest, k < Ns, start at
    ``offset`` in the kernel's table, after the nc split twiddles."""
    out, ns, off = [], 1, nc
    for r in _fft_passes(nc):
        if ns > 1:
            out.append((r, ns, off))
            off += (r - 1) * ns
        ns *= r
    return out


@dataclasses.dataclass(frozen=True)
class FftMelConstants:
    """K1's tables for one config: ``twiddles`` (n_fft, 2) f32 from float64,
    e^(-2πik/n_fft) for the split post-pass's k < n_fft/2, then each later
    FFT pass's own (``_pass_twiddles``; zeros after the last); the window's
    support [``ws``, ``we``) and its values there
    (``window``); the filterbank's bands, band m being the bins
    ``band_first[m]`` + [0, ``band_off[m+1] - band_off[m]``) with the
    weights ``band_w[band_off[m]:band_off[m+1]]``, in bin order."""

    twiddles: np.ndarray
    ws: int
    we: int
    window: np.ndarray
    band_first: np.ndarray
    band_off: np.ndarray
    band_w: np.ndarray


@functools.lru_cache(maxsize=8)
def fft_mel_constants(cfg: M.MelConfig) -> FftMelConstants:
    """The kernel's constants for ``cfg`` (see ``FftMelConstants``); the band
    weights are ``mel_filterbank_np``'s own numbers."""
    _check_config(cfg)
    n_fft = cfg.n_fft
    nc = n_fft // 2
    ang = [2 * np.pi * np.arange(nc) / n_fft]
    for r, ns, _ in _pass_twiddles(nc):
        ang.append((2 * np.pi * np.arange(1, r)[:, None] * np.arange(ns)[None, :]
                    / (ns * r)).reshape(-1))
    ang = np.concatenate(ang)
    tw = np.zeros((n_fft, 2))
    tw[:ang.size] = np.stack([np.cos(ang), -np.sin(ang)], -1)
    win = M.hann_window_np(cfg.win_length, n_fft)
    nz = np.nonzero(win)[0]
    ws, we = int(nz[0]), int(nz[-1]) + 1
    fb = M.mel_filterbank_np(cfg)
    if np.abs(fb[0]).max() != 0.0:
        raise ValueError("the DC bin must carry zero mel weight")
    first, off, w = [], [0], []
    for m in range(cfg.n_mels):
        bins = np.nonzero(fb[:, m])[0]
        if bins.size and bins[-1] - bins[0] + 1 != bins.size:
            raise ValueError(f"mel band {m} is not a run of consecutive bins: {bins}")
        first.append(int(bins[0]) if bins.size else 1)
        w.extend(fb[bins, m])
        off.append(len(w))
    return FftMelConstants(
        twiddles=tw.astype(np.float32), ws=ws, we=we, window=win[ws:we].astype(np.float32),
        band_first=np.asarray(first, np.int32), band_off=np.asarray(off, np.int32),
        band_w=np.asarray(w, np.float32))


def _mel_plan(cfg: M.MelConfig, batch: int, num_samples: int) -> dict:
    """The kernel's launch (``csrc/mel_power.cu`` checks the same limits):
    ``frames_per_cta`` frames a CTA, as many as 32 whose span of samples,
    (frames - 1) hop + the window's support, fits the staging limit;
    ``frames_in_flight`` = 4096 / n_fft frames transformed at once by
    n_fft/16 threads each; ``grid`` (frame tiles, batch); ``smem`` bytes:
    the twiddles, an FFT buffer a frame in flight (one spare point every 8;
    the power overwrites it), the staged mel tile, the band weights and the
    span."""
    c = fft_mel_constants(cfg)
    support = c.we - c.ws
    ft = min(_FT_MAX, (_SPAN_MAX - support) // cfg.hop_length + 1)
    nc = cfg.n_fft // 2
    fc = _THREADS // (nc // 8)
    n_frames = cfg.num_frames(num_samples)
    floats = (4 * nc + 2 * fc * (nc + nc // 8) + _N_MELS * (_FT_MAX + 1) + c.band_w.size
              + (ft - 1) * cfg.hop_length + support)
    return dict(frames_per_cta=ft, frames_in_flight=fc, threads=_THREADS,
                grid=(-(-n_frames // ft), batch), smem=4 * floats,
                passes=_fft_passes(nc), n_frames=n_frames)


@functools.lru_cache(maxsize=16)
def _device_constants(cfg: M.MelConfig, device: torch.device) -> tuple[torch.Tensor, ...]:
    c = fft_mel_constants(cfg)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (c.twiddles, c.window, c.band_off, c.band_first, c.band_w))


def mel_power(wave: torch.Tensor, cfg: M.MelConfig = M.MelConfig()) -> torch.Tensor:
    """Mel power spectrogram: (B, T) f32 → (B, n_mels, n_frames) f32.

    CUDA tensor: kernel K1 (``ValueError`` for a config it does not take).
    CPU tensor: ``ops.mel.mel_spectrogram``.
    """
    if wave.device.type == "cpu":
        return M.mel_spectrogram(wave, cfg)
    if wave.device.type != "cuda":
        raise ValueError(f"mel_power: unsupported device {wave.device}")
    if wave.ndim != 2 or wave.dtype != torch.float32:
        raise ValueError(
            f"mel_power: want a (B, T) float32 waveform, got {tuple(wave.shape)} "
            f"{wave.dtype}")
    _check_config(cfg)
    B, T = wave.shape
    if T <= cfg.n_fft // 2:
        raise ValueError(f"mel_power: reflect padding needs T > {cfg.n_fft // 2}, got {T}")
    wave = wave.contiguous()
    plan, c = _mel_plan(cfg, B, T), fft_mel_constants(cfg)
    tables = _device_constants(cfg, wave.device)
    out = torch.empty((B, cfg.n_mels, plan["n_frames"]), dtype=torch.float32,
                      device=wave.device)
    lib = _lib()
    with torch.cuda.device(wave.device):
        err = lib.dlsc_mel_power(
            wave.data_ptr(), *(t.data_ptr() for t in tables), out.data_ptr(), B, T,
            cfg.n_fft, cfg.hop_length, c.ws, c.we, cfg.n_mels, plan["n_frames"],
            plan["frames_per_cta"], c.band_w.size, torch.cuda.current_stream().cuda_stream)
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
