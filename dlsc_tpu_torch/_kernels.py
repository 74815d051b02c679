"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use with ``nvcc`` for ``sm_90a`` into its own shared library under
``build/dlsc_tpu_torch/`` at the repository root, then loaded with
``ctypes``. The library's file name carries a hash of the source, of every
header in ``csrc/`` (``*.cuh``, which a source may include) and of the
flags, so an edited source or header is rebuilt and never mixed with a stale
build. ``build(*names)`` compiles several sources at once, one ``nvcc`` each,
and keeps what ``nvcc`` printed beside the library (``build_log``: with
``-Xptxas -v`` among a library's ``EXTRA_FLAGS``, each kernel's registers and
spills). ``sass(name)`` disassembles a built library with ``cuobjdump``, and
``sass_functions(name)`` splits that by kernel.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception. There is no fallback: a
failed build, load or launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "build" / "dlsc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# flags of one library beside NVCC_FLAGS (part of its hash): the registers
# and spills of every library's kernels, which chip_smoke.py prints
EXTRA_FLAGS = {name: ("-Xptxas", "-v")
               for name in ("attn_fwd", "attn_bwd", "gmm", "mel_power", "ln_fused",
                            "dropout_draw")}

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


def _flags(name: str) -> tuple[str, ...]:
    return (*NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()))


def _paths(name: str) -> tuple[Path, Path]:
    src = _CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return src, _BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> None:
    """Build the named libraries that are not built yet: one ``nvcc`` per
    source, all started together, then waited for."""
    with _lock:
        procs = []
        for name in names:
            src, so = _paths(name)
            if so.exists():
                continue
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen([_nvcc(), *_flags(name), "-o", str(tmp), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            procs.append((name, src, so, tmp, proc, time.perf_counter()))
        failed = []
        for name, src, so, tmp, proc, t0 in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src.name} ({proc.returncode}):\n{out}\n{err}")
                continue
            so.with_suffix(".log").write_text(out + err)
            os.replace(tmp, so)
            build_seconds[name] = time.perf_counter() - t0
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build(name)
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = ctypes.CDLL(str(_paths(name)[1]))
        lib.dlsc_error_string.argtypes = [ctypes.c_int]
        lib.dlsc_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.dlsc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def build_log(name: str) -> str:
    """What ``nvcc`` printed when it built ``csrc/<name>.cu`` (built if needed)."""
    build(name)
    return _paths(name)[1].with_suffix(".log").read_text()


def _cuobjdump() -> str:
    """``cuobjdump`` of the CUDA toolkit, else the copy in Triton's package."""
    dirs = [Path(c) / "bin" for c in (os.environ.get("CUDA_HOME"), "/usr/local/cuda") if c]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin is not None:
        dirs.append(Path(spec.origin).parent / "backends" / "nvidia" / "bin")
    for d in dirs:
        if (d / "cuobjdump").exists():
            return str(d / "cuobjdump")
    raise RuntimeError(f"cuobjdump not found in {[str(d) for d in dirs]}")


def sass(name: str) -> str:
    """The SASS of the library built from ``csrc/<name>.cu`` (built if needed)."""
    build(name)
    return subprocess.run([_cuobjdump(), "-sass", str(_paths(name)[1])], capture_output=True,
                          text=True, check=True).stdout


def sass_functions(name: str) -> dict[str, str]:
    """``sass(name)`` split by function: mangled kernel name → its SASS."""
    parts = re.split(r"^\s*Function : (\S+)\s*$", sass(name), flags=re.MULTILINE)
    return dict(zip(parts[1::2], parts[2::2]))
