"""Serving benchmark: latency and throughput of the inference call, per row.

    python -m dlsc_tpu_torch.scripts.bench_infer [row ...]   # default: every row

The counterpart of ``scripts/bench_infer.py``: each row times the serving
call of ``serving.make_infer`` as ``scripts.predict`` makes it per request:
a host waveform batch (synthetic 5-s clips at 44.1 kHz, seeded) copied to
the card → the eval pipeline (log-mel on kernel K1 and the AST renorm; pad +
centre crop or ten crops; K1 at 1024/512/1024 + the 224² resize) → the
forward in eval mode (the mean over crops for ``envnet_10crop_b16``) →
softmax → the probabilities read back to the host. Models have seeded
random weights, the JAX rows' constructor defaults and dtypes (bf16 for the
AST family, f32 for the others). Per row:

- ``latency_ms``, ``latency_p90_ms``: the host clock around each call,
  copies included; median and 90th percentile of ``calls`` calls (20, and
  1000 for the batch-1 rows), after 3 warm-up calls;
- ``device_ms``: CUDA events around the call on a batch already on the card,
  without the readback, median of as many calls;
- ``clips_per_sec``: batch / median latency; ``device_clips_per_sec``:
  batch / median device ms.

One JSON line a row, the card's name in each. The int8 rows of the JAX
bench (``*_int8_*``, ``*_w8_*``) wait for M11; its relay-overhead estimate,
a TPU-relay artefact, has no counterpart. A row that fails fails the run.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from dlsc_tpu_torch.data.pipeline import DevicePipeline, PipelineConfig
from dlsc_tpu_torch.models.ast import ASTModel
from dlsc_tpu_torch.models.ast_mini import ASTMiniViT
from dlsc_tpu_torch.models.ast_moe import ASTMoE
from dlsc_tpu_torch.models.ast_small import ASTViTSmall
from dlsc_tpu_torch.models.cnn_esc50 import CNN_ESC50
from dlsc_tpu_torch.models.envnet_v2 import EnvNetV2
from dlsc_tpu_torch.models.leaf import LeafModel
from dlsc_tpu_torch.serving import make_infer

CLIP = 220_500          # 5 s at 44.1 kHz
NUM_CLASSES = 50
WARMUP_CALLS = 3
CALLS, CALLS_BATCH1 = 20, 1000

# name: (model, batch, dtype, pipeline kwargs), as scripts/bench_infer.py's rows
ROWS: dict[str, tuple[str, int, str, dict]] = {
    "ast_b1": ("ast", 1, "bfloat16", {}),
    "ast_b8": ("ast", 8, "bfloat16", {}),
    "ast_b64": ("ast", 64, "bfloat16", {}),
    "ast_b128": ("ast", 128, "bfloat16", {}),
    "ast_small_b1": ("ast_small", 1, "bfloat16", {}),
    "ast_small_b8": ("ast_small", 8, "bfloat16", {}),
    "ast_small_b64": ("ast_small", 64, "bfloat16", {}),
    "ast_small_b128": ("ast_small", 128, "bfloat16", {}),
    "ast_mini_b64": ("ast_mini", 64, "bfloat16", {}),
    "ast_mini_b128": ("ast_mini", 128, "bfloat16", {}),
    "ast_moe_b32": ("ast_moe", 32, "bfloat16", {}),
    "ast_moe_b64": ("ast_moe", 64, "bfloat16", {}),
    "envnet_b64": ("envnet_v2", 64, "float32", {}),
    "envnet_b128": ("envnet_v2", 128, "float32", {}),
    # the reference's 10-crop test-time protocol
    "envnet_10crop_b16": ("envnet_v2", 16, "float32", {"multi_crop_test": True}),
    "cnn_b64": ("cnn_esc50", 64, "float32", {}),
    "cnn_b256": ("cnn_esc50", 256, "float32", {}),
    "leaf_b32": ("leaf", 32, "float32", {}),
}


def build(which: str, dtype: str, pipe_kwargs: dict, device: torch.device, seed: int = 0,
          **model_kw) -> tuple[torch.nn.Module, DevicePipeline]:
    """(model in eval mode on ``device``, its eval pipeline) of a row: the
    JAX bench's models (remat off: serving has no backward); ``model_kw``
    overrides the model's arguments (the CPU test's tiny widths)."""
    gen = torch.Generator().manual_seed(seed)
    kw = dict(num_classes=NUM_CLASSES, dtype=dtype, generator=gen, device=device, **model_kw)
    mode = {"envnet_v2": "envnet_v2", "leaf": "envnet_v2", "cnn_esc50": "cnn_esc50"}.get(
        which, "ast")
    if which == "ast":
        model = ASTModel(**kw, remat=False)
    elif which == "ast_small":
        model = ASTViTSmall(**kw, remat=False)
    elif which == "ast_mini":
        model = ASTMiniViT(**kw)
    elif which == "ast_moe":
        model = ASTMoE(**kw, remat=False)
    elif which == "envnet_v2":
        model = EnvNetV2(**kw)
    elif which == "cnn_esc50":
        model = CNN_ESC50(**kw)
    elif which == "leaf":
        model = LeafModel(**kw, n_filters=128)
    else:
        raise ValueError(f"unknown model {which!r}")
    pipe = DevicePipeline(PipelineConfig(mode=mode, num_classes=NUM_CLASSES, window_length=5.0,
                                         padding_ratio=0.5, **pipe_kwargs))
    return model.eval(), pipe


def time_calls(fn, n: int, device: torch.device) -> tuple[list[float], list[float] | None]:
    """(host ms of each of ``n`` calls of ``fn()``, device ms of each of
    ``n`` calls of ``fn(on_device=True)`` by CUDA events; None, not
    measured, on the CPU)."""
    host = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    if device.type != "cuda":
        return host, None
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    for start, end in events:
        start.record()
        fn(on_device=True)
        end.record()
    torch.cuda.synchronize(device)
    return host, [s.elapsed_time(e) for s, e in events]


def run_row(name: str, device: torch.device, calls: int | None = None, clip: int = CLIP,
            **model_kw) -> dict:
    """Time one row (see the module docstring) and return its record. On
    the CPU (the tests, with ``model_kw`` widths) ``device_ms`` is None."""
    which, batch, dtype, pipe_kwargs = ROWS[name]
    model, pipe = build(which, dtype, pipe_kwargs, device, **model_kw)
    infer = make_infer(model, pipe)
    wave = (np.random.default_rng(0).standard_normal((batch, clip)) * 0.3).astype(np.float32)
    wave_dev = torch.from_numpy(wave).to(device)

    def call(on_device: bool = False) -> np.ndarray | torch.Tensor:
        if on_device:
            return infer(wave_dev)
        return infer(torch.from_numpy(wave).to(device)).float().cpu().numpy()

    for _ in range(WARMUP_CALLS):
        probs = call()
    if probs.shape != (batch, NUM_CLASSES) or not np.isfinite(probs).all() \
            or np.abs(probs.sum(-1) - 1.0).max() > 1e-3:
        raise RuntimeError(f"{name}: probabilities not finite, misshaped or not summing to 1")
    n = calls or (CALLS_BATCH1 if batch == 1 else CALLS)
    host, dev_ms = time_calls(call, n, device)
    lat = float(np.median(host))
    d = None if dev_ms is None else float(np.median(dev_ms))
    return {"variant": name, "model": which, "batch": batch, "dtype": dtype, "calls": n,
            "latency_ms": lat, "latency_p90_ms": float(np.percentile(host, 90)),
            "clips_per_sec": batch / lat * 1e3, "device_ms": d,
            "device_clips_per_sec": None if d is None else batch / d * 1e3,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}


def main(argv: list[str] | None = None) -> list[dict]:
    names = list(argv if argv is not None else sys.argv[1:]) or list(ROWS)
    unknown = [n for n in names if n not in ROWS]
    if unknown:
        raise SystemExit(f"unknown rows {unknown}; known: {list(ROWS)}")
    if not torch.cuda.is_available():
        raise RuntimeError("bench_infer needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    device = torch.device("cuda", 0)
    out = []
    for name in names:
        out.append(run_row(name, device))
        print(json.dumps(out[-1]), flush=True)
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
