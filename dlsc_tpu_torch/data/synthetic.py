"""Synthetic class-separable audio, with no download.

The port's copy of ``dlsc_tpu/data/synthetic.py``: each class is a distinct
fundamental with two harmonics and noise, so a model can learn it. The
numpy draws are the JAX package's, in the same order, so one seed gives the
same shard bytes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from dlsc_tpu_torch.data.prepare import write_fold_shards


def synth_clip(rng: np.random.Generator, label: int, n_samples: int,
               sr: int = 44_100) -> np.ndarray:
    f0 = 110.0 * (2.0 ** (label / 6.0))  # class-specific pitch
    t = np.arange(n_samples) / sr
    x = np.zeros(n_samples, dtype=np.float32)
    for h, amp in ((1, 1.0), (2, 0.5), (3, 0.25)):
        phase = rng.uniform(0, 2 * np.pi)
        x += amp * np.sin(2 * np.pi * f0 * h * t + phase).astype(np.float32)
    x += rng.standard_normal(n_samples).astype(np.float32) * 0.05
    x /= np.abs(x).max()
    return x


def make_synthetic_dataset(
    out_root: str | Path,
    num_classes: int = 10,
    clips_per_class_per_fold: int = 2,
    n_folds: int = 5,
    clip_samples: int = 44_100,
    seed: int = 0,
) -> dict:
    """Write a fold-sharded synthetic dataset in ``prepare.py``'s layout."""
    rng = np.random.default_rng(seed)
    fold_items: dict[int, list] = {}
    for fold in range(n_folds):
        items = []
        for label in range(num_classes):
            for i in range(clips_per_class_per_fold):
                x = synth_clip(rng, label, clip_samples)
                items.append((x, label, f"f{fold}_c{label}_{i}.wav", clip_samples))
        fold_items[fold] = items
    return write_fold_shards(
        Path(out_root), fold_items,
        {"sample_rate": 44_100, "clip_samples": clip_samples, "synthetic": True},
    )
