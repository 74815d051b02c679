"""Fold-based datamodules for ESC-50 and UrbanSound8K.

The port's counterpart of ``dlsc_tpu/data/datamodule.py``, with its split
semantics:

- one held-out test fold; the other folds form the train pool;
- a stratified validation split of the train pool that reproduces
  scikit-learn's ``StratifiedShuffleSplit(n_splits=1, test_size=val_split,
  random_state=42)`` index for index (``_stratified_split``; the card's
  machine has no scikit-learn), seed 42 being part of the fold protocol;
- a train/val leakage check;
- the config checks: BC mixing only with waveform modes, Mixup only with
  spectrogram modes.

Batches are slices of the mmap'd fold shards in their storage dtype (int16
PCM by default); the device pipeline (``data/pipeline.py``) turns them into
features on the card. ``train_batches`` and ``train_index_batches`` share
one batch composition (``_iter_index``), so the host-streamed path and the
device-resident pool see the same clips in the same order.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Iterator

import numpy as np

from dlsc_tpu_torch.data.pipeline import DevicePipeline, pipeline_from_dataset_config

_SPECTROGRAM_MODES = {"ast", "cnn_esc50"}
_WAVEFORM_MODES = {"envnet_v2", "raw"}
_KNOWN_MODES = _SPECTROGRAM_MODES | _WAVEFORM_MODES
VAL_SPLIT_SEED = 42


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """Per-class draws of ``n_draws`` in proportion to ``class_counts``:
    floors, then one more for the largest remainders, ties broken by
    ``rng`` (scikit-learn's ``utils.extmath._approximate_mode``)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_split(labels: np.ndarray, test_size: float,
                      seed: int = VAL_SPLIT_SEED) -> tuple[np.ndarray, np.ndarray]:
    """(train, test) indices of ``labels``, as the first split of
    ``StratifiedShuffleSplit(n_splits=1, test_size=test_size,
    random_state=seed)``: the same checks, the same draws from one
    ``RandomState(seed)`` in the same order, the same index order."""
    labels = np.asarray(labels)
    n = len(labels)
    if not 0 < test_size < 1:
        raise ValueError(f"test_size={test_size} should be a float in the (0, 1) range")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n} and test_size={test_size}, the train set "
                         "would be empty")
    classes, y_indices, class_counts = np.unique(labels, return_inverse=True,
                                                 return_counts=True)
    if class_counts.min() < 2:
        raise ValueError("The least populated classes in y have only 1 member, which is "
                         f"too few: {classes[class_counts < 2].tolist()}")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train size {n_train} and test size {n_test} must each be at "
                         f"least the number of classes {len(classes)}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: list = []
    test: list = []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


class Batch(dict):
    """dict with attribute access: wave (B, T) in the shards' dtype, label
    (B,) int32, mask (B,) bool (False for the padding rows of the last eval
    batch); index batches carry idx (B,) int32 in place of wave."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            # AttributeError keeps getattr(b, k, default) and hasattr working
            raise AttributeError(name) from None


class FoldDataModule:
    n_folds: int = 5

    def __init__(
        self,
        root: str,
        num_classes: int,
        fold: int = 0,
        val_split: float = 0.1,
        sample_rate: int = 44_100,
        batch_size: int = 64,
        num_workers: int = 0,           # accepted for config parity: the host side slices mmaps
        pin_memory: bool = True,        # config parity; the Trainer pins its own copies
        persistent_workers: bool = True,
        preprocessing_mode: str = "raw",
        is_spectrogram: bool = False,
        enable_mixup: bool = False,
        mixup_alpha: float = 0.5,
        enable_bc_mixing: bool = False,
        augment: dict | None = None,
        preprocessing_config: dict | None = None,
        drop_last_train: bool = True,
        **extra,
    ):
        if not 0 <= fold < self.n_folds:
            raise ValueError(f"fold must be in [0, {self.n_folds}), got {fold}")
        self.root = Path(root)
        self.num_classes = num_classes
        self.fold = fold
        self.val_split = val_split
        self.sample_rate = sample_rate
        self.batch_size = batch_size
        self.drop_last_train = drop_last_train
        self.dataset_cfg = {
            "preprocessing_mode": preprocessing_mode,
            "is_spectrogram": is_spectrogram,
            "enable_mixup": enable_mixup,
            "mixup_alpha": mixup_alpha,
            "enable_bc_mixing": enable_bc_mixing,
            "augment": augment or {},
            "preprocessing_config": preprocessing_config or {},
            "num_classes": num_classes,
            "sample_rate": sample_rate,
        }
        self._validate_config_constraints()
        self._train = self._val = self._test = None

    def _validate_config_constraints(self) -> None:
        cfg = self.dataset_cfg
        mode = cfg["preprocessing_mode"]
        if mode not in _KNOWN_MODES:
            raise ValueError(f"Unknown preprocessing_mode {mode!r}; known: {_KNOWN_MODES}")
        if cfg["enable_bc_mixing"] and mode in _SPECTROGRAM_MODES:
            raise ValueError("BC mixing requires a waveform preprocessing mode")
        if cfg["enable_mixup"] and mode not in _SPECTROGRAM_MODES:
            raise ValueError("Mixup requires a spectrogram preprocessing mode")
        if cfg["is_spectrogram"] != (mode in _SPECTROGRAM_MODES):
            raise ValueError(
                f"is_spectrogram={cfg['is_spectrogram']} inconsistent with mode {mode!r}")

    # -- setup ---------------------------------------------------------------
    def setup(self) -> None:
        if self._train is not None:
            return
        folds = {}
        for k in range(self.n_folds):
            d = self.root / f"fold_{k}"
            if not d.exists():
                raise FileNotFoundError(
                    f"{d} missing — write the shards first (data/prepare.py or "
                    "data/synthetic.py)")
            folds[k] = {
                "waves": np.load(d / "waves.npy", mmap_mode="r"),
                "labels": np.load(d / "labels.npy"),
                "names": json.loads((d / "names.json").read_text()),
            }
        test = folds[self.fold]
        train_folds = [folds[k] for k in range(self.n_folds) if k != self.fold]
        labels = np.concatenate([f["labels"] for f in train_folds])
        idx = np.arange(len(labels))
        if self.val_split > 0:
            train_idx, val_idx = _stratified_split(labels, self.val_split)
        else:
            train_idx, val_idx = idx, np.array([], dtype=int)
        if set(train_idx.tolist()) & set(val_idx.tolist()):
            raise RuntimeError("train/val overlap detected")

        self._pool = _ConcatWaves([f["waves"] for f in train_folds])
        self._pool_labels = labels
        self._pool_names = [n for f in train_folds for n in f["names"]]
        self._train = np.sort(train_idx)
        self._val = np.sort(val_idx)
        self._test = test

    # -- iteration -------------------------------------------------------------
    def _iter_index(self, order: np.ndarray, *, drop_last: bool,
                    training: bool = False) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """(sel, mask) index batches: the one batch composition of the host
        path and the device-resident path."""
        B = self.batch_size
        n = len(order)
        end = (n // B) * B if drop_last else n
        for s in range(0, end, B):
            sel = order[s:s + B]
            if len(sel) < B and training:
                # train steps carry no mask: pad with real samples (wrapped
                # repeats), not zero waveforms labelled class 0
                sel = np.tile(sel, -(-B // len(sel)))[:B]
            mask = np.ones(len(sel), dtype=bool)
            if len(sel) < B:  # pad the last eval batch to the fixed batch size
                pad = B - len(sel)
                sel = np.concatenate([sel, np.zeros(pad, sel.dtype)])
                mask = np.concatenate([mask, np.zeros(pad, dtype=bool)])
            yield sel.astype(np.int32), mask

    def _iter_split(self, waves, labels, order: np.ndarray, *, drop_last: bool,
                    training: bool = False) -> Iterator[Batch]:
        for sel, mask in self._iter_index(order, drop_last=drop_last, training=training):
            w = waves[sel]
            y = labels[sel]
            w = np.where(mask[(...,) + (None,) * (w.ndim - 1)], w, 0)
            y = np.where(mask, y, 0)
            yield Batch(wave=np.ascontiguousarray(w), label=y.astype(np.int32), mask=mask)

    def train_batches(self, epoch: int = 0, seed: int = 42) -> Iterator[Batch]:
        self.setup()
        order = self._train_order(epoch, seed)
        return self._iter_split(self._pool, self._pool_labels, order,
                                drop_last=self.drop_last_train, training=True)

    def val_batches(self) -> Iterator[Batch]:
        self.setup()
        return self._iter_split(self._pool, self._pool_labels, self._val, drop_last=False)

    def test_batches(self) -> Iterator[Batch]:
        self.setup()
        t = self._test
        return self._iter_split(t["waves"], t["labels"], np.arange(len(t["labels"])),
                                drop_last=False)

    def _train_order(self, epoch: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed + epoch)
        return self._train[rng.permutation(len(self._train))]

    # -- device-resident path: the fold pools live in device memory and each
    # step gathers its rows by index there, so a step's host→device traffic
    # is a (B,) index and a (B,) label vector -------------------------------
    @property
    def pool_nbytes(self) -> int:
        """Bytes of the train+val pool plus the test fold, in the shards' dtype."""
        self.setup()
        itemsize = self._pool.arrays[0].dtype.itemsize
        n = self._pool.shape[0] + len(self._test["labels"])
        return int(n * int(np.prod(self._pool.shape[1:])) * itemsize)

    def pool_parts(self) -> tuple[list[np.ndarray], np.ndarray, np.ndarray, np.ndarray]:
        """(train-pool arrays, one per fold, pool labels, test waves, test
        labels) for the one-time upload; one part per fold avoids a host concat."""
        self.setup()
        return (list(self._pool.arrays), self._pool_labels,
                self._test["waves"], self._test["labels"])

    def train_index_batches(self, epoch: int = 0, seed: int = 42) -> Iterator[Batch]:
        """(idx, label, mask) batches over the train pool, composed as
        ``train_batches``."""
        self.setup()
        order = self._train_order(epoch, seed)
        for sel, mask in self._iter_index(order, drop_last=self.drop_last_train,
                                          training=True):
            yield Batch(idx=sel, label=self._pool_labels[sel].astype(np.int32), mask=mask)

    def val_index_batches(self) -> Iterator[Batch]:
        self.setup()
        for sel, mask in self._iter_index(self._val, drop_last=False):
            y = np.where(mask, self._pool_labels[sel], 0)
            yield Batch(idx=sel, label=y.astype(np.int32), mask=mask)

    def test_index_batches(self) -> Iterator[Batch]:
        self.setup()
        t = self._test
        for sel, mask in self._iter_index(np.arange(len(t["labels"])), drop_last=False):
            y = np.where(mask, t["labels"][sel], 0)
            yield Batch(idx=sel, label=y.astype(np.int32), mask=mask, split="test")

    # -- sizes / metadata ------------------------------------------------------
    def setup_sizes(self) -> dict:
        self.setup()
        return {"train": len(self._train), "val": len(self._val),
                "test": len(self._test["labels"])}

    @property
    def clip_samples(self) -> int:
        """Samples per clip of the shards (the training clip length)."""
        self.setup()
        return int(self._pool.shape[1])

    @property
    def steps_per_epoch(self) -> int:
        self.setup()
        n = len(self._train)
        return n // self.batch_size if self.drop_last_train else -(-n // self.batch_size)

    @property
    def pipeline(self) -> DevicePipeline:
        return pipeline_from_dataset_config(self.dataset_cfg)

    def summary(self) -> str:
        sizes = self.setup_sizes()
        cfg = self.dataset_cfg
        return (f"{type(self).__name__}(root={self.root}, fold={self.fold}, "
                f"mode={cfg['preprocessing_mode']}, mixup={cfg['enable_mixup']}, "
                f"bc={cfg['enable_bc_mixing']}, sizes={sizes})")


class _ConcatWaves:
    """Lazy concat view over per-fold mmap'd (N_k, T) arrays with fancy
    indexing, so the train pool is never copied whole into host memory."""

    def __init__(self, arrays):
        self.arrays = arrays
        self.offsets = np.cumsum([0] + [len(a) for a in arrays])
        self.shape = (int(self.offsets[-1]),) + arrays[0].shape[1:]

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, idx):
        idx = np.asarray(idx)
        scalar = idx.ndim == 0
        idx = np.atleast_1d(idx)
        out = np.empty((len(idx),) + self.shape[1:], dtype=self.arrays[0].dtype)
        which = np.searchsorted(self.offsets, idx, side="right") - 1
        for k, a in enumerate(self.arrays):
            sel = which == k
            if sel.any():
                out[sel] = a[idx[sel] - self.offsets[k]]
        return out[0] if scalar else out


class ESC50DataModule(FoldDataModule):
    """ESC-50: 5 official folds."""

    n_folds = 5


class US8KDataModule(FoldDataModule):
    """UrbanSound8K: 10 official folds."""

    n_folds = 10
