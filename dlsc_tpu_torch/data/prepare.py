"""Offline dataset preparation: WAV → per-fold shards.

The port's copy of ``dlsc_tpu/data/prepare.py``, on the port's
``data/wav.py``: the same layout, byte for byte. One directory per fold
holds

- ``waves.npy``   int16 PCM (default) or float32, (N, T), fixed length
  (pad/trim), read with ``mmap_mode='r'`` by the datamodule;
- ``labels.npy``  int32 (N,);
- ``lengths.npy`` int32 (N,) original sample counts (pre-padding);
- ``names.json``  clip names;

plus a top-level ``dataset_stats.json`` (counts, duration, class
histogram). CSV folds are 1-based and shifted to 0-based. Progress is a
plain line every ``PROGRESS_EVERY`` clips.
"""

from __future__ import annotations

import csv
import hashlib
import json
from pathlib import Path

import numpy as np

from dlsc_tpu_torch.data import wav as W

TARGET_SR = 44_100
ESC50_SAMPLES = 5 * TARGET_SR          # every ESC-50 clip is 5 s
US8K_SAMPLES = 4 * TARGET_SR           # UrbanSound8K clips are <= 4 s
PROGRESS_EVERY = 500


def _pad_or_trim(x: np.ndarray, n: int) -> np.ndarray:
    if len(x) >= n:
        return x[:n]
    return np.pad(x, (0, n - len(x)))


def sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _progress(i: int, n: int, what: str) -> None:
    if (i + 1) % PROGRESS_EVERY == 0 or i + 1 == n:
        print(f"preparing {what}: {i + 1}/{n} clips", flush=True)


def write_fold_shards(
    out_root: Path,
    fold_items: dict[int, list[tuple[np.ndarray, int, str, int]]],
    stats_extra: dict | None = None,
    dtype: str = "int16",
) -> dict:
    """Write {fold: [(wave, label, name, orig_len), ...]} as shard dirs.

    ``dtype='int16'`` stores PCM16, the source WAVs' own precision (half the
    disk, host memory and host→device bytes of float32); the device pipeline
    rescales it to float. ``dtype='float32'`` keeps full-precision shards.
    """
    out_root = Path(out_root)
    out_root.mkdir(parents=True, exist_ok=True)
    class_hist: dict[str, int] = {}
    total_clips = 0
    total_seconds = 0.0
    for fold, items in sorted(fold_items.items()):
        d = out_root / f"fold_{fold}"
        d.mkdir(parents=True, exist_ok=True)
        waves = np.stack([it[0] for it in items]).astype(np.float32)
        if dtype == "int16":
            waves = np.clip(waves * 32767.0, -32768, 32767).astype(np.int16)
        labels = np.asarray([it[1] for it in items], dtype=np.int32)
        lengths = np.asarray([it[3] for it in items], dtype=np.int32)
        np.save(d / "waves.npy", waves)
        np.save(d / "labels.npy", labels)
        np.save(d / "lengths.npy", lengths)
        (d / "names.json").write_text(json.dumps([it[2] for it in items]))
        total_clips += len(items)
        total_seconds += float(lengths.sum()) / TARGET_SR
        for it in items:
            class_hist[str(it[1])] = class_hist.get(str(it[1]), 0) + 1
    stats = {
        "total_clips": total_clips,
        "total_duration_s": round(total_seconds, 2),
        "folds": {str(k): len(v) for k, v in sorted(fold_items.items())},
        "class_histogram": dict(sorted(class_hist.items(), key=lambda kv: int(kv[0]))),
        **(stats_extra or {}),
    }
    (out_root / "dataset_stats.json").write_text(json.dumps(stats, indent=2))
    return stats


def prepare_esc50(
    raw_root: str | Path,
    out_root: str | Path,
    validate_hash: bool = False,
    target_sr: int = TARGET_SR,
    progress: bool = True,
) -> dict:
    """ESC-50: ``raw_root`` must contain ``meta/esc50.csv`` and ``audio/*.wav``."""
    raw_root, out_root = Path(raw_root), Path(out_root)
    meta = raw_root / "meta" / "esc50.csv"
    if not meta.exists():
        raise FileNotFoundError(f"{meta} not found — run scripts/download_data.py first")
    with open(meta) as f:
        rows = list(csv.DictReader(f))
    fold_items: dict[int, list] = {}
    hashes = {}
    for i, row in enumerate(rows):
        path = raw_root / "audio" / row["filename"]
        if validate_hash:
            hashes[row["filename"]] = sha256_file(path)
        x = W.standardize(path, target_sr)
        orig = len(x)
        x = _pad_or_trim(x, ESC50_SAMPLES)
        fold = int(row["fold"]) - 1  # 1-based CSV → 0-based
        fold_items.setdefault(fold, []).append((x, int(row["target"]), row["filename"], orig))
        if progress:
            _progress(i, len(rows), "esc50")
    extra = {"sample_rate": target_sr, "clip_samples": ESC50_SAMPLES}
    if validate_hash:
        extra["sha256"] = hashes
    return write_fold_shards(out_root, fold_items, extra)


def prepare_us8k(
    raw_root: str | Path,
    out_root: str | Path,
    target_sr: int = TARGET_SR,
    progress: bool = True,
) -> dict:
    """UrbanSound8K: 10 official folds, clips padded/trimmed to 4 s."""
    raw_root, out_root = Path(raw_root), Path(out_root)
    meta = raw_root / "metadata" / "UrbanSound8K.csv"
    if not meta.exists():
        raise FileNotFoundError(f"{meta} not found")
    with open(meta) as f:
        rows = list(csv.DictReader(f))
    fold_items: dict[int, list] = {}
    for i, row in enumerate(rows):
        fold = int(row["fold"]) - 1
        path = raw_root / "audio" / f"fold{row['fold']}" / row["slice_file_name"]
        x = W.standardize(path, target_sr)
        orig = len(x)
        x = _pad_or_trim(x, US8K_SAMPLES)
        fold_items.setdefault(fold, []).append(
            (x, int(row["classID"]), row["slice_file_name"], orig))
        if progress:
            _progress(i, len(rows), "us8k")
    extra = {"sample_rate": target_sr, "clip_samples": US8K_SAMPLES}
    return write_fold_shards(out_root, fold_items, extra)
