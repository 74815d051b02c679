"""WAV decode/encode, mono, resample and peak-normalize in numpy.

The port's copy of ``dlsc_tpu/data/wav.py``, re-homed so that the serving
path imports no jax (``dlsc_tpu.data`` pulls jax in through its package
``__init__``). Same semantics: decode → mono mean → resample → peak
normalize (``standardize``). As there, ``standardize`` takes the C++ path
(``dlsc_tpu_torch/native.py``, built from ``native/dlsc_native.cpp``) for a
file when the library is available and this Python path otherwise, or for a
stream.
"""

from __future__ import annotations

import wave as _wave
from pathlib import Path
from typing import BinaryIO

import numpy as np


def read_wav(path: str | Path | BinaryIO) -> tuple[np.ndarray, int]:
    """Read a PCM WAV file or binary stream → (float32 samples (channels, T)
    in [-1, 1], sr)."""
    with _wave.open(path if hasattr(path, "read") else str(path), "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"Unsupported sample width {width} in {path}")
    return data.reshape(-1, n_ch).T, sr


def write_wav(path: str | Path, data: np.ndarray, sr: int) -> None:
    """Write float32 (channels, T) in [-1, 1] as PCM16."""
    if data.ndim == 1:
        data = data[None]
    pcm = np.clip(data.T * 32767.0, -32768, 32767).astype("<i2")
    with _wave.open(str(path), "wb") as w:
        w.setnchannels(data.shape[0])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def to_mono(data: np.ndarray) -> np.ndarray:
    """Channel mean (reference: prepare_esc50.py:96)."""
    return data.mean(axis=0) if data.ndim == 2 else data


def resample(data: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy), matching torchaudio's FIR class of
    resamplers. No-op when rates match (the common ESC-50 case)."""
    if sr == target_sr:
        return data
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr, target_sr)
    return resample_poly(data, target_sr // g, sr // g).astype(np.float32)


def peak_normalize(data: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    """Divide by peak magnitude (reference: prepare_esc50.py:98-101)."""
    peak = np.abs(data).max()
    return data / peak if peak > eps else data


def standardize(path: str | Path | BinaryIO, target_sr: int,
                prefer_native: bool = True) -> np.ndarray:
    """Full prep chain for one file: decode → mono → resample → peak-norm.

    Uses the C++ library (``dlsc_tpu_torch.native``) for a file path when
    it is available, and the Python path when it is not, for a stream, or
    where the library cannot parse the file (as ``dlsc_tpu/data/wav.py``
    falls back)."""
    if prefer_native and not hasattr(path, "read"):
        from dlsc_tpu_torch import native

        if native.available():
            try:
                return native.standardize(path, target_sr)
            except OSError:
                pass
    data, sr = read_wav(path)
    return peak_normalize(resample(to_mono(data), sr, target_sr)).astype(np.float32)
