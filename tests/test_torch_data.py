"""Port parity: the data path (shards, synthetic data, datamodule, prefetch).

The same numpy-seeded inputs go through the JAX package's data modules and
the port's, on the CPU. Tolerances: none: shard files are compared byte
for byte, fold splits and batch orders index for index, batches byte for
byte. The stratified validation split is held to scikit-learn's
``StratifiedShuffleSplit(random_state=42)`` itself, which the JAX
datamodule calls and the port reproduces without it.
"""

import csv
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from sklearn.model_selection import StratifiedShuffleSplit

import dlsc_tpu.native
import dlsc_tpu_torch.native
from dlsc_tpu.data import datamodule as JD
from dlsc_tpu.data import prepare as JP
from dlsc_tpu.data import synthetic as JS
from dlsc_tpu.data.loader import prefetch as jax_prefetch
from dlsc_tpu_torch.data import datamodule as D
from dlsc_tpu_torch.data import prepare as P
from dlsc_tpu_torch.data import synthetic as S
from dlsc_tpu_torch.data import wav as W
from dlsc_tpu_torch.data.loader import prefetch

def _same_tree(a: Path, b: Path) -> None:
    files_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    files_b = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert files_a == files_b and files_a
    for rel in files_a:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


# ---- shards -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_write_fold_shards_bytes_equal_jax(dtype, tmp_path):
    rng = np.random.default_rng(0)
    items = {fold: [((rng.standard_normal(300) * 0.7).astype(np.float32), int(rng.integers(5)),
                     f"clip_{fold}_{i}.wav", int(rng.integers(100, 300)))
                    for i in range(4 + fold)]
             for fold in (0, 2, 1)}
    extra = {"sample_rate": 44_100, "note": "x"}
    want = JP.write_fold_shards(tmp_path / "jax", items, extra, dtype=dtype)
    got = P.write_fold_shards(tmp_path / "port", items, extra, dtype=dtype)
    assert got == want
    _same_tree(tmp_path / "jax", tmp_path / "port")


@pytest.mark.parametrize("seed", [0, 3])
def test_make_synthetic_dataset_bytes_equal_jax(seed, tmp_path):
    kw = dict(num_classes=3, clips_per_class_per_fold=2, n_folds=5, clip_samples=2000, seed=seed)
    assert S.make_synthetic_dataset(tmp_path / "port", **kw) == JS.make_synthetic_dataset(
        tmp_path / "jax", **kw)
    _same_tree(tmp_path / "jax", tmp_path / "port")


def _fake_raw_tree(root: Path, kind: str) -> None:
    """A tiny ESC-50 or UrbanSound8K tree: its CSV and WAVs written by the
    port's ``write_wav``, mono and stereo, at 44.1 kHz and at 22.05 kHz (so
    that both the channel mean and the resampler run)."""
    rng = np.random.default_rng(1)
    rows = []
    for i in range(6):
        sr = 22_050 if i % 3 == 2 else 44_100
        ch = 2 if i % 2 else 1
        n = int(rng.integers(sr // 4, sr // 2))
        data = (rng.standard_normal((ch, n)) * 0.2).astype(np.float32)
        fold = i % 3 + 1
        if kind == "esc50":
            name = f"{fold}-{i}-A-{i % 4}.wav"
            path = root / "audio" / name
            rows.append({"filename": name, "fold": fold, "target": i % 4, "category": "x",
                         "esc10": "False", "src_file": i, "take": "A"})
        else:
            name = f"{i}-{i % 4}-0-0.wav"
            path = root / "audio" / f"fold{fold}" / name
            rows.append({"slice_file_name": name, "fsID": i, "start": 0, "end": 1,
                         "salience": 1, "fold": fold, "classID": i % 4, "class": "x"})
        path.parent.mkdir(parents=True, exist_ok=True)
        W.write_wav(path, data, sr)
    meta = root / ("meta/esc50.csv" if kind == "esc50" else "metadata/UrbanSound8K.csv")
    meta.parent.mkdir(parents=True, exist_ok=True)
    with open(meta, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


@pytest.mark.parametrize("kind", ["esc50", "us8k"])
def test_prepare_bytes_equal_jax(kind, tmp_path, monkeypatch):
    """The port's prepare against the JAX one, both on their Python decoder
    (both packages' C++ one is held to each other in
    ``tests/test_torch_small_clis.py``)."""
    monkeypatch.setattr(dlsc_tpu.native, "available", lambda: False)
    monkeypatch.setattr(dlsc_tpu_torch.native, "available", lambda: False)
    raw = tmp_path / "raw"
    _fake_raw_tree(raw, kind)
    if kind == "esc50":
        want = JP.prepare_esc50(raw, tmp_path / "jax", validate_hash=True, progress=False)
        got = P.prepare_esc50(raw, tmp_path / "port", validate_hash=True, progress=False)
    else:
        want = JP.prepare_us8k(raw, tmp_path / "jax", progress=False)
        got = P.prepare_us8k(raw, tmp_path / "port", progress=False)
    assert got == want and got["total_clips"] == 6
    _same_tree(tmp_path / "jax", tmp_path / "port")


# ---- the stratified split -----------------------------------------------------

def _labels(layout: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if layout == "esc50":               # 4 train folds of ESC-50: 50 classes x 32
        return np.repeat(np.arange(50), 32)
    if layout == "esc50_folds":         # the same, in fold-major order
        return np.tile(np.repeat(np.arange(50), 8), 4)
    if layout == "us8k":                # 9 folds of UrbanSound8K's uneven classes
        counts = [900, 386, 900, 900, 900, 900, 337, 900, 836, 900]
        return rng.permutation(np.repeat(np.arange(10), counts))
    if layout == "tiny":                # 2 classes, 10 and 13 clips
        return rng.permutation(np.repeat([0, 1], [10, 13]))
    if layout == "sparse_ids":          # class ids with gaps, uneven counts
        return rng.permutation(np.repeat(np.array([3, 7, 42]), [9, 15, 6]))
    raise ValueError(layout)


@pytest.mark.parametrize("val_split", [0.1, 0.2])
@pytest.mark.parametrize("layout", ["esc50", "esc50_folds", "us8k", "tiny", "sparse_ids"])
def test_stratified_split_equals_sklearn(layout, val_split):
    labels = _labels(layout)
    want = next(StratifiedShuffleSplit(n_splits=1, test_size=val_split, random_state=42)
                .split(np.arange(len(labels)), labels))
    got = D._stratified_split(labels, val_split)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype.kind == w.dtype.kind


@pytest.mark.parametrize("labels,val_split", [
    (np.array([0, 0, 0, 1, 2, 2]), 0.5),       # a class with 1 clip
    (np.array([0, 0, 1, 1, 2, 2]), 0.2),       # test size 2 < 3 classes
    (np.array([0, 0, 1, 1]), 0.9),             # train size 0
])
def test_stratified_split_refuses_as_sklearn(labels, val_split):
    with pytest.raises(ValueError):
        next(StratifiedShuffleSplit(n_splits=1, test_size=val_split, random_state=42)
             .split(np.arange(len(labels)), labels))
    with pytest.raises(ValueError):
        D._stratified_split(labels, val_split)


# ---- the datamodule -------------------------------------------------------------

@pytest.fixture(scope="module")
def shard_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    S.make_synthetic_dataset(root / "esc", num_classes=5, clips_per_class_per_fold=4,
                             clip_samples=300, seed=2)
    S.make_synthetic_dataset(root / "us8k", num_classes=3, clips_per_class_per_fold=3,
                             n_folds=10, clip_samples=200, seed=5)
    return root


def _batches_equal(got, want) -> int:
    n = 0
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w)
        for k in g:
            gv, wv = np.asarray(g[k]), np.asarray(w[k])
            assert gv.dtype == wv.dtype and gv.shape == wv.shape, k
            assert gv.tobytes() == wv.tobytes(), k
        n += 1
    return n


@pytest.mark.parametrize("kind,fold,val_split,batch_size,drop_last", [
    ("esc", 0, 0.1, 8, True),
    ("esc", 3, 0.2, 7, False),     # a short last train batch, wrap-padded
    ("esc", 1, 0.0, 16, True),     # no validation split
    ("us8k", 9, 0.1, 5, True),
])
def test_datamodule_matches_jax(shard_root, kind, fold, val_split, batch_size, drop_last):
    classes = 5 if kind == "esc" else 3
    cls_port = D.ESC50DataModule if kind == "esc" else D.US8KDataModule
    cls_jax = JD.ESC50DataModule if kind == "esc" else JD.US8KDataModule
    kw = dict(root=str(shard_root / kind), num_classes=classes, fold=fold, val_split=val_split,
              batch_size=batch_size, drop_last_train=drop_last, preprocessing_mode="ast",
              is_spectrogram=True, preprocessing_config={"n_mels": 128})
    got, want = cls_port(**kw), cls_jax(**kw)
    got.setup()
    want.setup()
    for attr in ("_train", "_val", "_pool_labels"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
    assert got._pool_names == want._pool_names
    assert got.setup_sizes() == want.setup_sizes()
    assert (got.steps_per_epoch, got.pool_nbytes) == (want.steps_per_epoch, want.pool_nbytes)
    for epoch in range(3):
        assert _batches_equal(got.train_batches(epoch, seed=42),
                              want.train_batches(epoch, seed=42)) > 0
        _batches_equal(got.train_index_batches(epoch, seed=42),
                       want.train_index_batches(epoch, seed=42))
    for name in ("val_batches", "test_batches", "val_index_batches", "test_index_batches"):
        _batches_equal(getattr(got, name)(), getattr(want, name)())
    tail = list(got.test_batches())[-1]   # the ragged eval tail: masked, zeroed rows
    n_test = got.setup_sizes()["test"]
    assert tail.mask.sum() == n_test - (len(list(got.test_batches())) - 1) * batch_size
    assert not tail.wave[~tail.mask].any() and not tail.label[~tail.mask].any()
    parts, labels, test_w, test_y = got.pool_parts()
    jparts, jlabels, jtest_w, jtest_y = want.pool_parts()
    assert all(np.array_equal(a, b) for a, b in zip(parts, jparts, strict=True))
    np.testing.assert_array_equal(test_w, jtest_w)
    assert got.clip_samples == want._pool.shape[1]


@pytest.mark.parametrize("kw", [
    dict(preprocessing_mode="mfcc"),
    dict(preprocessing_mode="ast", is_spectrogram=True, enable_bc_mixing=True),
    dict(preprocessing_mode="raw", enable_mixup=True),
    dict(preprocessing_mode="ast", is_spectrogram=False),
    dict(preprocessing_mode="ast", is_spectrogram=True, fold=5),
])
def test_datamodule_config_checks_match_jax(kw, tmp_path):
    for cls in (D.ESC50DataModule, JD.ESC50DataModule):
        with pytest.raises(ValueError):
            cls(root=str(tmp_path), num_classes=5, **kw)


# ---- prefetch -----------------------------------------------------------------

def test_prefetch_keeps_order_as_jax():
    got = list(prefetch(range(50), lambda x: x * 3, size=2))
    assert got == list(jax_prefetch(range(50), lambda x: x * 3, size=2)) == [
        x * 3 for x in range(50)]


def test_prefetch_forwards_an_exception():
    def items():
        yield 1
        yield 2
        raise KeyError("bad shard")

    seen = []
    with pytest.raises(KeyError, match="bad shard"):
        for x in prefetch(items(), lambda x: x, size=1):
            seen.append(x)
    assert seen == [1, 2]
    with pytest.raises(ZeroDivisionError):
        list(prefetch(range(3), lambda x: 1 // (x - 1)))


def test_prefetch_stops_its_thread_on_early_close():
    produced = []

    def transfer(x):
        produced.append(x)
        return x

    before = set(threading.enumerate())
    gen = prefetch(range(10_000), transfer, size=2)
    assert next(gen) == 0
    (worker,) = set(threading.enumerate()) - before
    gen.close()
    worker.join(timeout=5)
    assert not worker.is_alive()
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n < 10   # nothing produced after the close
