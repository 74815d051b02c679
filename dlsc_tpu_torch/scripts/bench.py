"""AST-Base train-step throughput on one GPU.

    python -m dlsc_tpu_torch.scripts.bench [--batch 64] [--steps 10] [--warmup 2] [--seed 0]

The configuration of the root ``bench.py`` (``bench.py:49-73``): AST-Base
(``configs/model/ast.yaml``) in bf16 with remat ``attn_res``, seeded random
weights; SpecAugment (time 192, freq 48) and Mixup (alpha 0.5); soft-label
cross-entropy; Adam lr 5e-4, weight decay 1e-6, cosine T_max 100 over 25
steps per epoch, global-norm clip 1.0; a batch of 64 synthetic 5-s clips
(220 500 samples at 44.1 kHz). The step is ``train/steps.py``'s, through
kernels K1, K2f and K2b.

Prints one JSON line: ``metric``, ``value`` (clips/s), ``unit``, ``batch``,
``step_ms`` (host clock over ``--steps`` steps ending in a synchronize,
after ``--warmup`` steps), ``mfu`` and ``hw_util`` (``utils/mfu.py`` over
the card's bf16 peak), ``device``, ``n_chips``, the peak device memory,
``profile`` (two more steps under ``torch.profiler``: device ms per step by
kind of kernel, the top kernels, the busy share) and ``decomp``, read from
that profile: the attention kernels K2f and K2b per step (depth launches
each) and the rest of the step. The attention FLOP convention is the useful
count of ``utils/mfu.py``: 4·n²·D forward and 10·n²·D backward at n_real.
A fixed batch runs or raises: no back-off.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from dlsc_tpu_torch.data.pipeline import DevicePipeline, PipelineConfig
from dlsc_tpu_torch.models.ast import ASTModel
from dlsc_tpu_torch.train.losses import CrossEntropyLoss
from dlsc_tpu_torch.train.metrics import MetricState
from dlsc_tpu_torch.train.optim import adam, cosine_annealing
from dlsc_tpu_torch.train.state import TrainState
from dlsc_tpu_torch.train.steps import make_train_step
from dlsc_tpu_torch.utils.mfu import ast_step_flops, ast_token_counts, peak_tflops

# configs/model/ast.yaml, written out: the card's machine may lack pyyaml.
AST_BASE = dict(num_classes=50, sample_rate=44_100, patch_size=16, patch_stride=10,
                overlap=6, pretrained_model="deit_base_patch16_384")
CLIP = 220_500
FLOP_CONVENTION = ("useful FLOPs (utils/mfu.py): parameter matmuls x3, attention "
                   "4·n²·D forward + 10·n²·D backward, at n_real tokens")
K2F, K2B = "K2f attention forward", "K2b attention backward"

# Device-kernel name fragments → the layer they belong to, first match wins.
_KERNEL_KINDS = (
    (K2F, ("attn_fwd",)),
    (K2B, ("attn_bwd",)),
    ("K1 mel", ("mel_power",)),
    ("GEMM (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "sm90_")),
    ("patch conv (cuDNN)", ("conv", "cudnn", "dgrad", "wgrad")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("optimizer", ("multi_tensor", "adam", "Adam")),
    ("copies and casts", ("copy", "Copy", "CatArray", "cat_")),
    ("reductions", ("reduce", "Reduce")),
    ("other elementwise", ("elementwise", "vectorized", "unrolled")),
)


def bench_pipeline() -> DevicePipeline:
    return DevicePipeline(PipelineConfig(mode="ast", num_classes=AST_BASE["num_classes"],
                                         time_mask=192, freq_mask=48, enable_mixup=True,
                                         mixup_alpha=0.5))


def build(batch: int, seed: int, device: torch.device):
    """(train_step, state, metric state, waves, labels) of the bench on ``device``."""
    model = ASTModel(**AST_BASE, dtype=torch.bfloat16, remat=True, remat_policy="attn_res",
                     generator=torch.Generator().manual_seed(seed), device=device)
    state = TrainState.create(model, adam(lr=5e-4, weight_decay=1e-6),
                              cosine_annealing(T_max=100), steps_per_epoch=25,
                              gradient_clip_val=1.0, seed=seed)
    rng = np.random.default_rng(seed)
    wave = torch.from_numpy((rng.standard_normal((batch, CLIP)) * 0.3).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, AST_BASE["num_classes"], batch))
    step = make_train_step(bench_pipeline(), CrossEntropyLoss())
    return (step, state, MetricState.create(AST_BASE["num_classes"], device),
            wave.to(device), labels.to(device))


def timed_steps(step, state, ms, wave, labels, warmup: int, steps: int):
    """``warmup`` steps, then ``steps`` steps on the host clock ending in a
    synchronize. Returns (state, ms, every loss as numpy, seconds per timed
    step); raises on a non-finite loss."""
    losses = []
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, ms, loss = step(state, ms, wave, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite loss in the bench steps: {losses}")
    return state, ms, losses, step_s


def profile_steps(step, state, ms, wave, labels, n: int = 2, top: int = 15) -> dict:
    """``n`` steps under ``torch.profiler``: device ms per step by kind of
    kernel, the ``top`` kernels, and the device's busy share of the
    profiled wall time (the profiler slows the host, so the share is a
    lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, ms, _ = step(state, ms, wave, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
    kinds: dict[str, float] = {}
    for name, t in by_name.items():
        kind = next((k for k, frags in _KERNEL_KINDS if any(f in name for f in frags)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + t / n
    busy = sum(by_name.values())
    return {
        "steps": n,
        "device_ms_per_step": busy / n,
        "wall_ms_per_step": wall_ms / n,
        "busy_share": busy / wall_ms,
        "by_kind_ms": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": {name[:90]: t / n for name, t in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:top]},
    }


def record(model: torch.nn.Module, batch: int, step_s: float, losses: np.ndarray,
           peak_mem_gib: float, prof: dict) -> dict:
    """The bench's JSON record from a measured step time and a profile."""
    cfg = model.config
    n_real, n_pad = ast_token_counts(model, CLIP)
    fl = ast_step_flops(model, n_real, n_pad)
    name = torch.cuda.get_device_name()
    peak = peak_tflops(name) * 1e12
    kinds = prof["by_kind_ms"]
    attn_ms = kinds.get(K2F, 0.0) + kinds.get(K2B, 0.0)
    return {
        "metric": "AST-Base train-step throughput (K1 mel + SpecAugment + Mixup + ViT-Base "
                  "bf16 fwd/bwd, remat attn_res, + Adam), 5-s clips",
        "value": batch / step_s,
        "unit": "clips/s",
        "batch": batch,
        "step_ms": step_s * 1e3,
        "mfu": fl.useful * batch / step_s / peak,
        "hw_util": fl.hardware * batch / step_s / peak,
        "device": name,
        "n_chips": 1,
        "peak_mem_gib": peak_mem_gib,
        "losses": losses.tolist(),
        "flop_convention": FLOP_CONVENTION,
        "decomp": {
            "attn_fwd_ms": kinds.get(K2F, 0.0),
            "attn_bwd_ms": kinds.get(K2B, 0.0),
            "attn_ms": attn_ms,
            "rest_ms": prof["device_ms_per_step"] - attn_ms,
            "note": f"device ms per step under the profiler: K2f + K2b, {cfg['depth']} "
                    f"launches each at (B {batch}, H {cfg['num_heads']}, N {n_pad}, dh 64) "
                    f"bf16, n_real {n_real}; rest = the other kernels",
        },
        "profile": prof,
    }


def measure(batch: int = 64, steps: int = 10, warmup: int = 2, seed: int = 0) -> dict:
    """Run the bench and return its JSON record (see the module docstring)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the bench needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    step, state, ms, wave, labels = build(batch, seed, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state, ms, losses, step_s = timed_steps(step, state, ms, wave, labels, warmup, steps)
    peak_mem = torch.cuda.max_memory_allocated(dev) / 2**30
    prof = profile_steps(step, state, ms, wave, labels)
    return record(state.model, batch, step_s, losses, peak_mem, prof)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rec = measure(args.batch, args.steps, args.warmup, args.seed)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
