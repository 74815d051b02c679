"""ctypes binding of the C++ WAV decoder and data-path helpers
(``native/dlsc_native.cpp``).

The port's counterpart of ``dlsc_tpu/native``: ``wav_info``, ``wav_decode``,
``read_wav``, ``mono_mix``, ``peak_normalize``, ``resample`` (a
Kaiser-windowed sinc polyphase resampler) and ``standardize`` (decode →
mono → resample → peak-normalize), with ``available()``.
``data/wav.standardize(prefer_native=True)`` takes this path when the
library is there, as the JAX package's does; the Python path of
``data/wav.py`` is the reference's own fallback for a missing host library.

The library is compiled on first use with ``g++`` (the flags of
``native/Makefile``) into ``build/dlsc_tpu_torch/`` at the repository root,
its file name carrying a hash of the source and the flags, as
``_kernels.py`` names its CUDA libraries; nothing is built into or written
to ``native/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from math import gcd
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "dlsc_native.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "build" / "dlsc_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None   # why the library is unavailable, once tried


def library_path() -> Path:
    """Where the built library lies: ``build/dlsc_tpu_torch/libdlsc_native-<hash>.so``."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return _BUILD / f"libdlsc_native-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build native/dlsc_native.cpp")
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {_SRC.name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL | None:
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError) as e:
            _error = str(e)
            return None
        i64, i32, f32p = ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_float)
        lib.wav_info.restype = i64
        lib.wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(i32), ctypes.POINTER(i32)]
        lib.wav_decode.restype = i64
        lib.wav_decode.argtypes = [ctypes.c_char_p, f32p, i64]
        lib.mono_mix.argtypes = [f32p, i64, i32, f32p]
        lib.peak_normalize.argtypes = [f32p, i64, ctypes.c_float]
        lib.resample_out_len.restype = i64
        lib.resample_out_len.argtypes = [i64, i32, i32]
        lib.resample_poly.restype = i64
        lib.resample_poly.argtypes = [f32p, i64, i32, i32, f32p, i64]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library is built (or builds now) and loads."""
    return _load() is not None


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native library is unavailable: {_error}")
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def wav_info(path: str | Path) -> tuple[int, int, int]:
    """(frames, sample rate, channels) of a PCM WAV file."""
    sr, ch = ctypes.c_int32(), ctypes.c_int32()
    frames = _need().wav_info(str(path).encode(), ctypes.byref(sr), ctypes.byref(ch))
    if frames < 0:
        raise OSError(f"cannot parse {path}")
    return int(frames), sr.value, ch.value


def wav_decode(path: str | Path, frames: int, channels: int) -> np.ndarray:
    """The interleaved samples of up to ``frames`` frames, float32 in [-1, 1]:
    (frames read × channels,)."""
    buf = np.empty(frames * channels, dtype=np.float32)
    got = _need().wav_decode(str(path).encode(), _fp(buf), frames)
    if got < 0:
        raise OSError(f"decode failed for {path}")
    return buf[:got * channels]


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode → ((channels, T) float32, sr), as ``data/wav.read_wav``."""
    frames, sr, ch = wav_info(path)
    return wav_decode(path, frames, ch).reshape(-1, ch).T.copy(), sr


def mono_mix(data: np.ndarray) -> np.ndarray:
    """Channel mean of (channels, T) → (T,)."""
    inter = np.ascontiguousarray(data.T, dtype=np.float32)  # (T, C)
    out = np.empty(inter.shape[0], dtype=np.float32)
    _need().mono_mix(_fp(inter), inter.shape[0], inter.shape[1], _fp(out))
    return out


def peak_normalize(x: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    """x · (1 / max |x|) when the peak exceeds ``eps`` (a copy)."""
    x = np.array(x, dtype=np.float32, copy=True)
    _need().peak_normalize(_fp(x), x.size, eps)
    return x


def resample(x: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """The library's polyphase resampler; unchanged when the rates match."""
    if sr == target_sr:
        return np.asarray(x, dtype=np.float32)
    lib = _need()
    g = gcd(sr, target_sr)
    up, down = target_sr // g, sr // g
    x = np.ascontiguousarray(x, dtype=np.float32)
    n_out = lib.resample_out_len(len(x), up, down)
    out = np.empty(n_out, dtype=np.float32)
    got = lib.resample_poly(_fp(x), len(x), up, down, _fp(out), n_out)
    return out[:got]


def standardize(path: str | Path, target_sr: int) -> np.ndarray:
    """Decode → mono → resample → peak-normalize, in the library."""
    data, sr = read_wav(path)
    return peak_normalize(resample(mono_mix(data), sr, target_sr))
