"""The inference bench (``dlsc_tpu_torch/scripts/bench_infer.py``): its row
table against the JAX ``scripts/bench_infer.py`` (every row but the int8
ones, with the same model, batch, dtype and pipeline), and one tiny row of
each pipeline kind through the serving call on the CPU (where ``device_ms``
is not measured). Its GPU numbers come only from the card
(``chip_smoke.py`` phase 22)."""

import inspect

import numpy as np
import pytest
import torch

import scripts.bench_infer as jax_bench
from dlsc_tpu_torch.models.envnet_v2 import EnvNetV2
from dlsc_tpu_torch.scripts import bench_infer

ROWS = ["ast_b1", "ast_b8", "ast_b64", "ast_b128", "ast_small_b1", "ast_small_b8",
        "ast_small_b64", "ast_small_b128", "ast_mini_b64", "ast_mini_b128", "ast_moe_b32",
        "ast_moe_b64", "envnet_b64", "envnet_b128", "envnet_10crop_b16", "cnn_b64", "cnn_b256",
        "leaf_b32"]


def test_rows_are_the_jax_rows_but_int8():
    assert list(bench_infer.ROWS) == ROWS
    jax_rows = {k: v for k, v in jax_bench.VARIANTS.items() if len(v) == 4}
    assert set(jax_rows) == set(ROWS)
    assert all(len(v) == 5 for k, v in jax_bench.VARIANTS.items() if k not in ROWS)
    for name in ROWS:
        assert bench_infer.ROWS[name] == jax_rows[name], name


@pytest.mark.parametrize("name,kw", [
    ("ast_mini_b64", dict(clip=16_000, emb_dim=64, depth=1, num_heads=2)),
    ("cnn_b64", dict(clip=16_000)),
])
def test_one_tiny_row_on_the_cpu(name, kw, monkeypatch):
    monkeypatch.setattr(bench_infer, "WARMUP_CALLS", 1)
    rec = bench_infer.run_row(name, torch.device("cpu"), calls=2, **kw)
    assert rec["variant"] == name and rec["batch"] == 64 and rec["calls"] == 2
    assert rec["device"] == "cpu" and rec["device_ms"] is None
    assert rec["device_clips_per_sec"] is None
    assert np.isfinite(rec["latency_ms"]) and rec["latency_ms"] > 0
    assert rec["clips_per_sec"] == pytest.approx(64 / rec["latency_ms"] * 1e3)


def test_multi_crop_row_builds_a_ten_crop_pipeline(monkeypatch):
    built = {}
    monkeypatch.setattr(bench_infer, "EnvNetV2", lambda **kw: built.setdefault("m", _Stub(kw)))
    _, pipe = bench_infer.build("envnet_v2", "float32", {"multi_crop_test": True},
                                torch.device("cpu"))
    assert pipe.multi_crop and pipe.cfg.test_crops == 10
    default = inspect.signature(EnvNetV2).parameters["input_samples"].default
    assert "input_samples" not in built["m"].kw and default == pipe.cfg.window_samples


class _Stub(torch.nn.Module):
    def __init__(self, kw):
        super().__init__()
        self.kw = kw


def test_main_needs_a_gpu_and_known_rows(monkeypatch):
    with pytest.raises(SystemExit, match="unknown rows"):
        bench_infer.main(["ast_int8_b1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        bench_infer.main(["ast_b1"])
