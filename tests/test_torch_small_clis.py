"""M9b: the port's small CLIs, feature cache and native WAV decoder against
the JAX package's, on the CPU.

- ``prepare_esc50`` / ``prepare_urbansound8k`` (the port's CLIs) against
  the JAX ``prepare_esc50`` / ``prepare_us8k`` on a synthetic raw tree
  (mono and stereo, 44.1 and 22.05 kHz): every shard and stats file
  byte-equal, each package on its C++ decoder (the same source).
- ``tracking_ui --print`` and its HTML index against the JAX script's for
  one runs directory: equal text.
- ``FeatureCache``: one sequence of puts, gets (hits, misses, a corrupt
  entry), age cleanup and size-limited eviction on each package's cache:
  equal stats, the same entries removed in the same (oldest-first) order,
  no orphan sidecar; ``cache_manager`` stats / cleanup / optimize /
  benchmark on the CPU.
- ``native``: the library builds into ``build/dlsc_tpu_torch/`` and leaves
  ``native/`` as it was; ``wav_info`` / ``read_wav`` bitwise equal to the
  Python decoder; ``standardize`` within 1e-7 absolute of the Python path
  at equal rates (peak-normalised samples in [-1, 1]; the library multiplies
  by 1/peak where numpy divides: 1 ulp, 6e-8 measured), and
  bitwise equal to the JAX package's native path when it resamples;
  ``data/wav.standardize`` takes the library when it is there.
- ``check_specs`` on the CPU.
"""

import hashlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import dlsc_tpu.native as jax_native
import scripts.tracking_ui as jax_tracking_ui
from dlsc_tpu.data import prepare as JP
from dlsc_tpu.data.cache import FeatureCache as JaxFeatureCache
from dlsc_tpu.tracking.tracker import Tracker as JaxTracker
from dlsc_tpu_torch import native
from dlsc_tpu_torch.data import wav as W
from dlsc_tpu_torch.data.cache import FeatureCache, config_hash
from dlsc_tpu_torch.scripts import (cache_manager, check_specs, prepare_esc50,
                                    prepare_urbansound8k, tracking_ui)
from dlsc_tpu_torch.tracking.tracker import Tracker
from tests.test_torch_data import _fake_raw_tree, _same_tree

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("kind", ["esc50", "us8k"])
def test_prepare_clis_bytes_equal_jax(kind, tmp_path, capsys):
    assert native.available() and jax_native.available()
    raw = tmp_path / "raw"
    _fake_raw_tree(raw, kind)
    if kind == "esc50":
        want = JP.prepare_esc50(raw, tmp_path / "jax", validate_hash=True, progress=False)
        got = prepare_esc50.main(["--raw", str(raw), "--out", str(tmp_path / "port"),
                                  "--validate-hash"])
    else:
        want = JP.prepare_us8k(raw, tmp_path / "jax", progress=False)
        got = prepare_urbansound8k.main(["--raw", str(raw), "--out", str(tmp_path / "port")])
    assert got == want and got["total_clips"] == 6
    _same_tree(tmp_path / "jax", tmp_path / "port")
    assert f"prepared 6 clips" in capsys.readouterr().out


def _runs(root: Path) -> None:
    """Two experiments' runs, one finished, one still running."""
    for exp, accs in (("ast", (0.5, 0.75)), ("leaf", (0.25,))):
        for i, acc in enumerate(accs):
            t = Tracker(exp, root=root)
            t.log_metrics({"train/acc": acc - 0.1, "val/acc": acc, "train/loss": 1.5}, step=0)
            t.log_metric("test/f1", acc / 2)
            if i == 0:
                t.finish()
            time.sleep(0.01)


def test_tracking_ui_equals_jax(tmp_path, capsys, monkeypatch):
    root = tmp_path / "runs"
    _runs(root)
    tracking_ui.main(["--root", str(root), "--print"])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["tracking_ui.py", "--root", str(root), "--print"])
    jax_tracking_ui.main()
    want = capsys.readouterr().out
    assert got == want and got.count("\n") == 3 and "val/acc" in got
    assert tracking_ui.render_index(root) == jax_tracking_ui.render_index(root)
    # a run written by the JAX tracker reads the same in the port's index
    JaxTracker("jax", root=root).log_metric("val/acc", 0.5)
    assert tracking_ui.render_index(root) == jax_tracking_ui.render_index(root)
    with pytest.raises(SystemExit, match="no runs"):
        tracking_ui.main(["--root", str(tmp_path / "none"), "--print"])


def _cache_sequence(cache, clock):
    """Puts, gets, a corrupt entry, age cleanup and eviction: (hits, stats
    after the gets, removed by age, evicted, keys left, orphan sidecars)."""
    rng = np.random.default_rng(0)
    for i in range(6):
        cache.put(f"k{i}", rng.standard_normal((8, 10 + 40 * i)).astype(np.float32),
                  {"source": f"clip{i}.wav"})
        os.utime(cache._entry(f"k{i}"), (clock - (6 - i) * 86400,) * 2)   # k0 oldest
    hits = [cache.get(f"k{i}") is not None for i in (0, 3, 7)]
    cache._entry("k5").write_bytes(b"not an npz")
    os.utime(cache._entry("k5"), (clock - 86400,) * 2)
    hits.append(cache.get("k5") is not None)
    stats = {k: v for k, v in cache.report().items()
             if k not in ("cache_dir", "config_hash", "avg_load_ms", "avg_save_ms", "total_mb")}
    removed = cache.cleanup_by_age(5.5)            # k0 (6 days old)
    sizes = {p.name.split("_")[0]: p.stat().st_size for p in cache.entries()}
    budget = sum(sizes.values()) - sizes["k1"] - 1   # needs k1 and k2 to go
    evicted = cache.enforce_size_limit(budget)
    left = sorted(p.name.split("_")[0] for p in cache.entries())
    orphans = [p.name for p in cache.dir.glob("*.json")
               if not p.with_suffix(".npz").exists()]
    return hits, stats, removed, evicted, left, orphans


def test_cache_equals_jax(tmp_path):
    clock = time.time()
    port = FeatureCache(tmp_path / "port", config={"mode": "ast"})
    jax_cache = JaxFeatureCache(tmp_path / "jax", config={"mode": "ast"})
    got, want = _cache_sequence(port, clock), _cache_sequence(jax_cache, clock)
    assert got == want
    hits, stats, removed, evicted, left, orphans = got
    assert hits == [True, True, False, False] and stats["errors"] == 1
    assert (removed, evicted, left, orphans) == (1, 2, ["k3", "k4"], [])
    # keys and sidecars: the same file key, the config hash folds in torch's version
    wav = tmp_path / "a.wav"
    W.write_wav(wav, np.zeros((1, 100), np.float32), 8000)
    from dlsc_tpu.data.cache import file_key as jax_file_key
    from dlsc_tpu_torch.data.cache import file_key
    assert file_key(wav) == jax_file_key(wav)
    assert config_hash({"mode": "ast"}) != config_hash({"mode": "cnn_esc50"})
    side = json.loads(port._entry("k3").with_suffix(".json").read_text())
    assert side["source"] == "clip3.wav" and side["shape"] == [8, 130]


def test_config_hash_folds_in_torch(monkeypatch):
    import torch

    before = config_hash({"mode": "ast"})
    monkeypatch.setattr(torch, "__version__", "0.0.0")
    assert config_hash({"mode": "ast"}) != before


def test_cache_manager_cli(tmp_path, capsys):
    d = str(tmp_path / "cache")
    cache_manager.main(["--cache-dir", d, "benchmark", "--mode", "ast", "--n", "2",
                        "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["n_clips"] == 2 and out["hits"] == 2 and out["device"] == "cpu"
    cache_manager.main(["--cache-dir", d, "stats"])
    assert json.loads(capsys.readouterr().out)["n_entries"] == 2
    cache_manager.main(["--cache-dir", d, "optimize", "--max-size", "0"])
    assert "evicted 2 entries" in capsys.readouterr().out
    cache_manager.main(["--cache-dir", d, "cleanup", "--max-age", "30"])
    assert "removed 0 entries" in capsys.readouterr().out


def _native_tree():
    files = sorted((REPO / "native").iterdir())
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in files}


def test_native_decoder(tmp_path, monkeypatch):
    before = _native_tree()
    assert native.available()
    assert native.library_path().parent == REPO / "build" / "dlsc_tpu_torch"
    assert native.library_path().exists() and _native_tree() == before
    rng = np.random.default_rng(5)
    for ch, sr in ((1, 44_100), (2, 44_100), (2, 22_050)):
        path = tmp_path / f"c{ch}_{sr}.wav"
        W.write_wav(path, (rng.standard_normal((ch, 3001)) * 0.3).astype(np.float32), sr)
        assert native.wav_info(path) == (3001, sr, ch)
        data, got_sr = native.read_wav(path)
        want, want_sr = W.read_wav(path)
        assert got_sr == want_sr and np.array_equal(data, want)
        np.testing.assert_array_equal(native.mono_mix(data), jax_native.mono_mix(data))
        got = native.standardize(path, 44_100)
        np.testing.assert_array_equal(got, jax_native.standardize(path, 44_100))
        assert np.array_equal(W.standardize(path, 44_100), got)   # the library's path
        if sr == 44_100:
            py = W.standardize(path, 44_100, prefer_native=False)
            np.testing.assert_allclose(got, py, rtol=0, atol=1e-7)
    with pytest.raises(OSError):
        native.wav_info(tmp_path / "missing.wav")
    # without the library, the Python path
    monkeypatch.setattr(native, "available", lambda: False)
    path = tmp_path / "c2_22050.wav"
    np.testing.assert_array_equal(W.standardize(path, 44_100),
                                  W.standardize(path, 44_100, prefer_native=False))


def test_check_specs_on_the_cpu(capsys):
    check_specs.main([])
    out = capsys.readouterr().out
    for section in ("== host ==", "== torch ==", "== nvidia-smi (name, power.limit) =="):
        assert section in out
    import torch
    assert f"version: {torch.__version__}" in out
    assert check_specs.nvidia_smi() == [] or all("," in line for line in check_specs.nvidia_smi())
