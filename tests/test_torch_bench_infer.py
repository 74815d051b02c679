"""The inference bench (``dlsc_tpu_torch/scripts/bench_infer.py``): its row
table against the JAX ``scripts/bench_infer.py`` (every row, the int8 ones
with their quant mode, with the same model, batch, dtype and pipeline), and
one tiny row of each pipeline kind and of each int8 mode through the
serving call on the CPU (where ``device_ms`` and ``enqueue_span_ms`` are not
measured). Its GPU numbers come only from the card (``chip_smoke.py``
phase 22)."""

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
INT8_ROWS = ["ast_int8_b1", "ast_int8_b64", "ast_small_int8_b64", "ast_mini_int8_b64",
             "ast_w8_b1", "ast_w8_b8", "ast_w8_b64", "ast_small_w8_b1", "ast_small_w8_b8",
             "ast_small_w8_b64"]


def test_rows_are_the_jax_rows_but_int8():
    """Every row of the JAX bench, the int8 ones (5-tuples with their quant
    mode) after the others."""
    assert list(bench_infer.ROWS) == ROWS + INT8_ROWS
    assert set(jax_bench.VARIANTS) == set(ROWS + INT8_ROWS)
    assert all(len(jax_bench.VARIANTS[k]) == 5 for k in INT8_ROWS)
    for name in ROWS + INT8_ROWS:
        assert bench_infer.ROWS[name] == jax_bench.VARIANTS[name], name


@pytest.mark.parametrize("name,kw", [
    ("ast_mini_b64", dict(clip=16_000, emb_dim=64, depth=1, num_heads=2)),
    ("cnn_b64", dict(clip=16_000)),
])
def test_one_tiny_row_on_the_cpu(name, kw, monkeypatch):
    monkeypatch.setattr(bench_infer, "WARMUP_CALLS", 1)
    rec = bench_infer.run_row(name, torch.device("cpu"), calls=2, **kw)
    assert rec["variant"] == name and rec["batch"] == 64 and rec["calls"] == 2
    assert rec["device"] == "cpu" and rec["device_ms"] is None
    assert rec["device_clips_per_sec"] is None and rec["enqueue_span_ms"] is None
    assert rec["graph_replays"] is None and rec["quant"] is None
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
        bench_infer.main(["ast_int4_b1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        bench_infer.main(["ast_b1"])


@pytest.mark.parametrize("name", ["ast_mini_int8_b64", "ast_small_w8_b1"])
def test_int8_rows_on_the_cpu(name, monkeypatch):
    """An int8 row builds its model in the row's quant mode (int8 buffers
    quantised from the seeded float weights) and serves at tiny widths."""
    monkeypatch.setattr(bench_infer, "WARMUP_CALLS", 1)
    kw = dict(clip=16_000, emb_dim=64, depth=1, num_heads=2)
    rec = bench_infer.run_row(name, torch.device("cpu"), calls=2, **kw)
    assert rec["variant"] == name and rec["quant"] == bench_infer.ROWS[name][4]
    assert rec["batch"] == bench_infer.ROWS[name][1] and np.isfinite(rec["latency_ms"])
    model, _ = bench_infer.build(*bench_infer.ROWS[name][:1], *bench_infer.ROWS[name][2:4],
                                 torch.device("cpu"), rec["quant"], emb_dim=64, depth=1,
                                 num_heads=2)
    qkv = model.blocks[0].attn.qkv
    assert model.quant == rec["quant"] and qkv.weight_q.dtype == torch.int8
    assert qkv.weight_q.abs().max() == 127


def test_eval_constants_stay_on_the_device():
    """The eval pipelines' constants (ten crops' indices, the CNN's resize
    matrices) are made on the device once, so that a call copies nothing
    from the host and its CUDA graph (``device_ms``) can be captured; the
    crops are the evenly spaced ones of the JAX pipeline's f32 linspace."""
    from dlsc_tpu_torch.data import pipeline as P
    from dlsc_tpu_torch.ops import augment as A

    wave = torch.arange(2 * 1000, dtype=torch.float32).reshape(2, 1000)
    a, b = A.multi_crop(wave, 100, 10), A.multi_crop(wave, 100, 10)
    assert torch.equal(a, b)
    assert A._crop_index(1000, 100, 10, wave.device) is A._crop_index(1000, 100, 10, wave.device)
    starts = np.floor(np.linspace(0.0, 900.0, 10, dtype=np.float32)).astype(np.int64)
    assert torch.equal(a[:, :, 0], wave[:, starts])
    cpu = torch.device("cpu")
    assert P._resize_matrix(7, 5, cpu) is P._resize_matrix(7, 5, cpu)
    assert torch.equal(P._resize_matrix(7, 5, cpu), torch.from_numpy(P.resize_matrix_np(7, 5)))
