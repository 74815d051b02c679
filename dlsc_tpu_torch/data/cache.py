"""Content-hashed feature cache with stats and eviction.

The port's copy of ``dlsc_tpu/data/cache.py``: the same keys, stats, age
cleanup, oldest-first eviction and JSON sidecars, with torch's version
folded into the config hash where the JAX package folds in jax's. No
training path reads the cache; ``scripts/cache_manager.py`` drives it.

Parity component for the reference's AdvancedCacheManager
(reference: src/datasets/preprocessing.py:152-388): entries keyed by
md5(name, size, mtime) + a config hash (which folds in library versions,
:620-650), hit/miss/timing stats behind a lock (:120-149), age-based cleanup
and oldest-first size-limit eviction (:312-383), JSON metadata sidecars
(:168-194).

In this stack the hot path computes features on device per step, so the
cache's role is narrower: persisting *precomputed* features for host-side
workflows (analysis, export) and backing scripts/cache_manager.py. Entries
are .npz instead of gzip-pickle.
"""

from __future__ import annotations

import hashlib
import json
import platform
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    saves: int = 0
    errors: int = 0
    load_ms: list = field(default_factory=list)
    save_ms: list = field(default_factory=list)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def to_dict(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "saves": self.saves,
            "errors": self.errors,
            "hit_rate": round(self.hit_rate, 4),
            "avg_load_ms": round(float(np.mean(self.load_ms)), 3) if self.load_ms else 0.0,
            "avg_save_ms": round(float(np.mean(self.save_ms)), 3) if self.save_ms else 0.0,
        }


def config_hash(config: dict) -> str:
    """Hash of the preprocessing config + environment versions
    (version changes invalidate entries, reference :620-650)."""
    import torch

    payload = {
        "config": config,
        "python": platform.python_version(),
        "torch": torch.__version__,
        "numpy": np.__version__,
    }
    return hashlib.md5(json.dumps(payload, sort_keys=True, default=str).encode()).hexdigest()[:16]


def file_key(path: str | Path) -> str:
    p = Path(path)
    st = p.stat()
    return hashlib.md5(f"{p.name}:{st.st_size}:{st.st_mtime_ns}".encode()).hexdigest()[:16]


class FeatureCache:
    def __init__(self, cache_dir: str | Path = "data/cache", config: dict | None = None):
        self.dir = Path(cache_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.cfg_hash = config_hash(config or {})
        self.stats = CacheStats()
        self._lock = threading.Lock()

    def _entry(self, key: str) -> Path:
        return self.dir / f"{key}_{self.cfg_hash}.npz"

    # -- get/put ------------------------------------------------------------
    def get(self, key: str) -> np.ndarray | None:
        path = self._entry(key)
        t0 = time.perf_counter()
        if not path.exists():
            with self._lock:
                self.stats.misses += 1
            return None
        try:
            with np.load(path) as z:
                arr = z["features"]
            with self._lock:
                self.stats.hits += 1
                self.stats.load_ms.append((time.perf_counter() - t0) * 1e3)
            return arr
        except Exception:
            with self._lock:
                self.stats.errors += 1
            path.unlink(missing_ok=True)  # degrade to recompute (ref :272-310)
            path.with_suffix(".json").unlink(missing_ok=True)  # no orphan sidecar
            return None

    def put(self, key: str, features: np.ndarray, meta: dict | None = None) -> None:
        path = self._entry(key)
        t0 = time.perf_counter()
        try:
            np.savez_compressed(path, features=np.asarray(features))
            side = {"created": time.time(), "shape": list(np.shape(features)),
                    **(meta or {})}
            path.with_suffix(".json").write_text(json.dumps(side))
            with self._lock:
                self.stats.saves += 1
                self.stats.save_ms.append((time.perf_counter() - t0) * 1e3)
        except Exception:
            with self._lock:
                self.stats.errors += 1

    def get_or_compute(self, path: str | Path, compute) -> np.ndarray:
        key = file_key(path)
        cached = self.get(key)
        if cached is not None:
            return cached
        feats = np.asarray(compute())
        self.put(key, feats, {"source": str(path)})
        return feats

    # -- maintenance -----------------------------------------------------------
    def entries(self) -> list[Path]:
        return sorted(self.dir.glob("*.npz"))

    def total_bytes(self) -> int:
        return sum(p.stat().st_size for p in self.entries())

    def cleanup_by_age(self, max_age_days: float) -> int:
        """Delete entries older than max_age_days (reference :312-340)."""
        cutoff = time.time() - max_age_days * 86400
        removed = 0
        for p in self.entries():
            if p.stat().st_mtime < cutoff:
                p.unlink(missing_ok=True)
                p.with_suffix(".json").unlink(missing_ok=True)
                removed += 1
        return removed

    def enforce_size_limit(self, max_bytes: int) -> int:
        """Evict oldest-first down to max_bytes (reference :342-383)."""
        entries = sorted(self.entries(), key=lambda p: p.stat().st_mtime)
        total = sum(p.stat().st_size for p in entries)
        removed = 0
        for p in entries:
            if total <= max_bytes:
                break
            total -= p.stat().st_size
            p.unlink(missing_ok=True)
            p.with_suffix(".json").unlink(missing_ok=True)
            removed += 1
        return removed

    def report(self) -> dict:
        return {
            "cache_dir": str(self.dir),
            "config_hash": self.cfg_hash,
            "n_entries": len(self.entries()),
            "total_mb": round(self.total_bytes() / 1e6, 2),
            **self.stats.to_dict(),
        }
