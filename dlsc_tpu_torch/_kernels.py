"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use with ``nvcc`` for ``sm_90a`` into its own shared library under
``build/dlsc_tpu_torch/`` at the repository root, then loaded with
``ctypes``. The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt and never mixed with a stale build.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception. There is no fallback: a
failed build, load or launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "build" / "dlsc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}   # nvcc time per library built by this process


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH): the CUDA "
            "kernels of dlsc_tpu_torch cannot be built on this host")
    return found


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = _CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = _BUILD / f"lib{name}-{digest}.so"
        if not so.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} ({proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
            build_seconds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        lib.dlsc_error_string.argtypes = [ctypes.c_int]
        lib.dlsc_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.dlsc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
