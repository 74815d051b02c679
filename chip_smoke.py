#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dlsc_tpu_torch) of AST-Base and AST-MoE serving and training on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own lines; any failure raises (exit code != 0):

0. start-up: require CUDA, print the card's name and power limit, turn TF32
   off for matmuls and cuDNN, build the four kernel sources from csrc/ (one
   nvcc each, all at once);
1. kernel K1 (mel power) against its plain version, both mel configs at the
   serving batch 8, and the AST config at the training batch 64;
2. kernel K2f (attention forward) against its plain version, f32 and bf16,
   beside ``F.scaled_dot_product_attention`` with the same key mask, then
   bf16 at the training batch 64;
3. kernel K2b (attention backward) against its plain version at AST-Base
   shapes, f32 and bf16 at batch 8, beside the SDPA backward, then bf16 at
   the training batch 64;
4. the serving slice: AST-Base (bf16, seeded random weights) exported,
   loaded on the card and served over HTTP to a burst of concurrent
   requests; the launch counters must show that every device batch went
   through K1 and K2f; one batch is then held against the same weights run
   with plain ops in f32, and serving latency and throughput are timed;
5. the training slice: ``scripts/bench.py``'s configuration (AST-Base bf16,
   remat ``attn_res``, SpecAugment + Mixup, Adam, batch 64), 2 warm-up and
   10 timed steps; every loss finite, every parameter changed, and per step
   K1 1, K2f 12 and K2b 12 launches; then two profiled steps and the
   bench's JSON record;
6. card parity of one train step at full width (B 4, the same draws): f32
   through the kernels vs f32 with plain attention, and bf16 through the
   kernels (remat ``attn_res``) vs that f32 plain step;
7. kernels K2f and K2b at AST-MoE's training shape (64, 6, 768, 64),
   n_real 689, bf16, against their plain versions one batch row at a time;
8. kernels K4a (gmm) and K4b (tgmm) against their plain versions at
   AST-MoE's batch-64 shapes (88 192 sorted rows): the two expert products,
   their transposed-rhs dlhs and both tgmm, bf16 with the group sizes of a
   real router draw and with a skewed set, f32 at one shape, beside
   ``torch._grouped_mm``;
9. AST-MoE serving: exported with seeded weights, loaded on the card, one
   batch of 8 clips (per device batch K1 1, K2f 12, gmm 24, K2b and tgmm
   0), held against the same weights in f32 with plain attention and plain
   grouped matmul on the same routes, and timed at batch 8 and 64;
10. AST-MoE training: ``scripts/bench.py --model ast_moe``'s configuration,
    2 warm-up and 10 timed steps at batch 64 (per step K1 1, K2f 12, K2b 12,
    gmm 72, tgmm 24), every parameter and every expert changed, then the
    bench's profiled record;
11. AST-MoE card parity of one train step at batch 4, dropout 0.1 with one
    seed: f32 kernels vs f32 plain ops, bf16 kernels (remat ``attn_res``)
    vs f32 plain ops, each pair on the same routes.

Routes: a near-tie between two router gates flips a token's expert under a
perturbation as small as bf16 rounding, and a flipped route moves a whole
expert output. The MoE checks therefore record the run under test's top-k
choices and replay them in the plain run (``RouteLog``), so that they hold
the kernels to their plain versions; they also print how many routes a
free run would flip, and what that does to the outputs.

The last two lines are a JSON object with each kernel's launches, error,
times and bound, and ``{"ok": true, "device": {...}}``. Needs no network
and one card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import http.client
import json
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from dlsc_tpu_torch import _kernels
from dlsc_tpu_torch.data import wav as W
from dlsc_tpu_torch.data.pipeline import DevicePipeline, PipelineConfig
from dlsc_tpu_torch.models.ast import ASTModel
from dlsc_tpu_torch.models.ast_moe import ASTMoE
from dlsc_tpu_torch.models.moe import MOE_METRICS
from dlsc_tpu_torch.models.vit import ASTViT
from dlsc_tpu_torch.ops import attn_fast, mel_kernel
from dlsc_tpu_torch.ops import gmm as gmm_ops
from dlsc_tpu_torch.ops import mel as M
from dlsc_tpu_torch.scripts import bench
from dlsc_tpu_torch.server import ModelServer
from dlsc_tpu_torch.serving import export_model, load_exported, make_infer
from dlsc_tpu_torch.train.losses import CrossEntropyLoss
from dlsc_tpu_torch.train.metrics import MetricState
from dlsc_tpu_torch.train.optim import sgd
from dlsc_tpu_torch.train.state import TrainState
from dlsc_tpu_torch.train.steps import make_train_step
from dlsc_tpu_torch.utils.mfu import peak_tflops

AST_BASE = bench.AST_BASE   # configs/model/ast.yaml, written out
CLIP = bench.CLIP           # 5 s at 44.1 kHz
DEPTH = 12
HEADS = 12
N_PAD, N_REAL = 1664, 1645  # AST-Base tokens at 5 s, padded to the 128 grain
SERVE_BATCH = 8
BURST = 16              # concurrent /predict_raw requests, plus one /predict
LATENCY_SAMPLES = 100   # batch-1 calls timed: p90 has 10 samples beyond it
TRAIN_BATCH, WARMUP_STEPS, TIMED_STEPS = 64, 2, 10
PARITY_BATCH = 4
AST_MOE = bench.AST_MOE  # configs/model/ast_moe.yaml, written out
MOE_HEADS, MOE_DIM, MOE_FF = 6, 384, 1536
MOE_N_PAD, MOE_N_REAL = 768, 689  # AST-MoE tokens at 5 s (8 x 86 patches + CLS)
MOE_ROWS = TRAIN_BATCH * MOE_N_REAL * AST_MOE["top_k"]   # 88 192 sorted rows at batch 64
# one expert with more than half the rows, an empty one, no multiple of 128
SKEWED_SIZES = (45_001, 0, 12_345, 9_999, 7_777, 6_543, 4_321, 2_206)

# The card's peaks (NVIDIA H100 SXM data sheet, 700 W): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over the
# peak of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12       # f32 outside the tensor cores (K1's FMA)

# Tolerances, each with its reason.
MEL_NORM_ERR = 1e-4     # tests/test_mel_pallas.py bar; f32 FMA sums reach ~1e-6
DB_ABS_ERR = 1e-2       # same bars for the dB and AST-feature epilogues
AST_ABS_ERR = 1e-3
ATTN_F32_ERR = 1e-4     # f32 both sides; only the summation order differs
ATTN_BF16_ERR = 2e-2    # P is rounded to bf16 before P·V and out is stored
                        # in bf16 (2^-8 relative of |out| up to a few units)
SLICE_F32_ERR = 1e-3    # sigmoid outputs, f32 kernels vs f32 plain ops
SLICE_BF16_ERR = 3e-2   # sigmoid outputs, bf16 served model vs f32 plain ops:
                        # 12 blocks of bf16 rounding (2^-8 relative per op)
PROB_SUM_ERR = 1e-3
BWD_F32_ERR = 1e-4      # K2b f32, normalised by max |grad|: summation order only
BWD_BF16_ERR = 2e-2     # K2b bf16: P and dS rounded to bf16 before their
                        # products and the gradients stored in bf16, as the
                        # plain version does, so the gap is summation order in
                        # bf16-rounded operands (2^-8 relative each)
STEP_F32_LOSS = 1e-4    # f32 step through the kernels vs plain attention:
STEP_F32_GRAD = 1e-4    # loss relative; gradients and parameters after the
                        # update normalised per parameter (a zero-initialised
                        # bias after one step is lr x its gradient, so the
                        # parameter bar is the gradient's): the kernels' f32
                        # summation order, through 12 blocks
STEP_BF16_LOSS = 1e-2   # bf16 step vs the f32 plain step: 12 blocks of bf16
STEP_BF16_GRAD = 5e-2   # activations (2^-8 relative per op) forward and back
GMM_F32_ERR = 1e-5      # K4 f32, normalised by max |out|: summation order only
GMM_BF16_ERR = 1e-2     # K4 bf16: the output rounded to bf16 (2^-9 relative),
                        # f32 sums on both sides


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_times(fn, iters: int = 10, warmup: int = 2) -> list[float]:
    """Device milliseconds of each of ``iters`` calls (CUDA events), after warm-up."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def paired_ms(kernel_fn, plain_fn) -> tuple[float, float]:
    """Median (kernel ms, plain ms), timed in turns: kernel, plain, plain, kernel."""
    k0, p0, p1, k1 = (cuda_times(f) for f in (kernel_fn, plain_fn, plain_fn, kernel_fn))
    return float(np.median(k0 + k1)), float(np.median(p0 + p1))


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def bound(flops: float, peak_flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over their peak."""
    t_ops, t_bytes = flops / peak_flops, nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def norm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in f32."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def _reset_launches() -> None:
    mel_kernel.reset_launches()
    attn_fast.reset_launches()
    gmm_ops.reset_launches()


def _launch_counts() -> dict:
    """Every kernel's launches since the last ``_reset_launches``."""
    return dict(k1=mel_kernel.launches, k2f=attn_fast.launches, k2b=attn_fast.bwd_launches,
                gmm=gmm_ops.launches, tgmm=gmm_ops.tgmm_launches)


class RouteLog:
    """The router's top-k choices of one run (``record``, the model's
    ``topk``), replayed in call order in another run (``replay``): values
    from the replaying run's own gates, indices from the recorded run."""

    def __init__(self):
        self.routes = []

    def record(self, gates: torch.Tensor, k: int):
        vals, idx = torch.topk(gates, k, dim=-1, sorted=True)
        self.routes.append(idx)
        return vals, idx

    def replay(self, n_calls: int):
        it = iter(self.routes[:n_calls])

        def topk(gates, k):
            idx = next(it)
            return gates.gather(-1, idx), idx
        return topk

    def flips(self, other: "RouteLog", n_real: int) -> tuple[int, int]:
        """(differing, all) real-token (token, choice) routes of the first
        forward, block by block."""
        pairs = list(zip(self.routes[:DEPTH], other.routes[:DEPTH]))
        diff = sum(int((a[:, :n_real] != b[:, :n_real]).sum()) for a, b in pairs)
        return diff, sum(a[:, :n_real].numel() for a, _ in pairs)


def phase_mel(dev: torch.device, gen: torch.Generator) -> dict:
    wave = (torch.randn(SERVE_BATCH, CLIP, generator=gen) * 0.3).to(dev)
    result = {}
    for cfg in (M.MelConfig(), M.MelConfig(n_fft=1024, hop_length=512, win_length=1024)):
        got = mel_kernel.mel_power(wave, cfg)
        ref = M.mel_spectrogram(wave, cfg)
        require(got.shape == ref.shape, f"K1 shape {tuple(got.shape)} vs {tuple(ref.shape)}")
        norm = ((got - ref).abs().max() / ref.abs().max()).item()
        abs_err = (got - ref).abs().max().item()
        got_db, ref_db = M.amplitude_to_db(got, cfg.top_db), M.amplitude_to_db(ref, cfg.top_db)
        db = (got_db - ref_db).abs().max().item()
        ast = (M.ast_normalize(got_db) - M.ast_normalize(ref_db)).abs().max().item()
        ms, plain_ms = paired_ms(lambda: mel_kernel.mel_power(wave, cfg),
                                 lambda: M.mel_spectrogram(wave, cfg))
        print(f"K1 mel_power hop {cfg.hop_length} win {cfg.win_length}: B {SERVE_BATCH} x "
              f"{CLIP} -> {tuple(got.shape)}  norm_err {norm:.3e} (< {MEL_NORM_ERR})  "
              f"max_abs {abs_err:.3e}  dB {db:.3e} (< {DB_ABS_ERR})  ast {ast:.3e} "
              f"(< {AST_ABS_ERR})  median kernel {ms:.3f} ms  plain {plain_ms:.3f} ms",
              flush=True)
        require(norm < MEL_NORM_ERR and db < DB_ABS_ERR and ast < AST_ABS_ERR,
                f"K1 disagrees with its plain version at hop {cfg.hop_length}")
        if cfg.hop_length == M.AST_HOP_LENGTH:  # the slice's config
            # what the function needs at the least, not the dense DFT product
            # the kernel runs: per frame the window, a real FFT (~2.5 n log2 n),
            # the power (3 per bin) and the filterbank's nonzero entries (2
            # each); bytes: the wave, those entries and the output, each once
            nnz = int(np.count_nonzero(M.mel_filterbank_np(cfg)))
            per_frame = (cfg.win_length + 2.5 * cfg.n_fft * np.log2(cfg.n_fft)
                         + 3 * (cfg.n_fft // 2 + 1) + 2 * nnz)
            flops = SERVE_BATCH * cfg.num_frames(CLIP) * per_frame
            nbytes = 4 * (SERVE_BATCH * CLIP + nnz + got.numel())
            # no single PyTorch call computes a mel power spectrogram
            result = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, library_ms=None,
                          **bound(flops, F32_FLOPS, nbytes))

    # the training slice's shape: the whole batch of 64 clips in one launch
    cfg = M.MelConfig()
    wave = (torch.randn(TRAIN_BATCH, CLIP, generator=gen) * 0.3).to(dev)
    got, ref = mel_kernel.mel_power(wave, cfg), M.mel_spectrogram(wave, cfg)
    require(got.shape == ref.shape, f"K1 shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    norm, abs_err = norm_err(got, ref), (got - ref).abs().max().item()
    ms = float(np.median(cuda_times(lambda: mel_kernel.mel_power(wave, cfg))))
    print(f"K1 mel_power at the train batch: B {TRAIN_BATCH} x {CLIP} -> {tuple(got.shape)}  "
          f"norm_err {norm:.3e} (< {MEL_NORM_ERR})  max_abs {abs_err:.3e}  median kernel "
          f"{ms:.3f} ms", flush=True)
    require(norm < MEL_NORM_ERR, f"K1 disagrees with its plain version at batch {TRAIN_BATCH}")
    result["max_abs_err"] = max(result["max_abs_err"], abs_err)
    return result


def _key_mask(n: int, n_real: int, dev: torch.device) -> torch.Tensor:
    """SDPA's boolean mask for keys < n_real, broadcast over (B, H, queries)."""
    return (torch.arange(n, device=dev) < n_real)[None, None, None, :]


def _attn_bytes(B: int, H: int, N: int, dh: int, n_tensors: int, elem: int) -> int:
    """``n_tensors`` (B, H, N, dh) tensors of ``elem`` bytes, plus one f32 lse."""
    return n_tensors * B * H * N * dh * elem + 4 * B * H * N


def _train_attn_inputs(dev: torch.device, gen: torch.Generator, n_tensors: int,
                       heads: int = HEADS, n: int = N_PAD) -> list:
    """``n_tensors`` bf16 (TRAIN_BATCH, heads, n, 64) tensors, the first (q)
    pre-scaled, drawn on the card from a seed taken from ``gen``."""
    g = torch.Generator(dev).manual_seed(int(torch.randint(2**31, (1,), generator=gen)))
    ts = [torch.randn(TRAIN_BATCH, heads, n, 64, generator=g, device=dev)
          for _ in range(n_tensors)]
    ts[0] = ts[0] * 64**-0.5
    return [t.to(torch.bfloat16) for t in ts]


def _per_batch(fn, *tensors: torch.Tensor) -> tuple:
    """``fn`` on one batch row at a time, its outputs concatenated: a plain
    version's f32 (H, N, N) temporaries for a whole train batch would take
    tens of GB."""
    outs = [fn(*(t[b:b + 1] for t in tensors)) for b in range(tensors[0].shape[0])]
    return tuple(torch.cat(o) for o in zip(*outs))


def phase_attn(dev: torch.device, gen: torch.Generator) -> dict:
    B, H, N, dh, n_real = SERVE_BATCH, HEADS, N_PAD, 64, N_REAL
    q, k, v = (torch.randn(B, H, N, dh, generator=gen) for _ in range(3))
    q = q * dh**-0.5
    q, k, v = (t.to(dev) for t in (q, k, v))
    rows = slice(0, n_real)   # pad query rows are never read

    out, lse = attn_fast.fast_mha_forward(q, k, v, n_real)
    ref, ref_lse = attn_fast.mha_forward_reference(q, k, v, n_real)
    e_out = (out - ref)[:, :, rows].abs().max().item()
    e_lse = (lse - ref_lse)[:, :, rows].abs().max().item()
    ms32, plain32 = paired_ms(lambda: attn_fast.fast_mha_forward(q, k, v, n_real),
                              lambda: attn_fast.mha_forward_reference(q, k, v, n_real))
    print(f"K2 attn_fwd f32  (B {B}, H {H}, N {N}, dh {dh}, n_real {n_real}): out "
          f"{e_out:.3e} lse {e_lse:.3e} (<= {ATTN_F32_ERR})  median kernel {ms32:.3f} ms  "
          f"plain {plain32:.3f} ms", flush=True)
    require(e_out <= ATTN_F32_ERR and e_lse <= ATTN_F32_ERR, "K2 f32 disagrees")

    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    out, lse = attn_fast.fast_mha_forward(qb, kb, vb, n_real)
    ref, ref_lse = attn_fast.mha_forward_reference(qb.float(), kb.float(), vb.float(), n_real)
    e_out = (out.float() - ref)[:, :, rows].abs().max().item()
    e_lse = (lse - ref_lse)[:, :, rows].abs().max().item()
    ms, plain = paired_ms(lambda: attn_fast.fast_mha_forward(qb, kb, vb, n_real),
                          lambda: attn_fast.mha_forward_reference(qb, kb, vb, n_real))
    print(f"K2 attn_fwd bf16 (same shape, f32 plain version on the same bf16 inputs): "
          f"out {e_out:.3e} lse {e_lse:.3e} (<= {ATTN_BF16_ERR})  median kernel {ms:.3f} ms  "
          f"plain {plain:.3f} ms", flush=True)
    require(e_out <= ATTN_BF16_ERR and e_lse <= ATTN_BF16_ERR, "K2 bf16 disagrees")

    # yardstick, never on the port's path: SDPA with the same boolean key mask
    mask = _key_mask(N, n_real, dev)
    lib = float(np.median(cuda_times(lambda: F.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=mask, scale=1.0))))
    bd = bound(4 * B * H * N * n_real * dh, BF16_TENSOR_FLOPS, _attn_bytes(B, H, N, dh, 4, 2))
    print(f"K2 attn_fwd bf16: F.scaled_dot_product_attention (boolean key mask) {lib:.3f} ms; "
          f"bound {bd['bound_ms']:.3f} ms ({bd['bound_by']})", flush=True)
    del qb, kb, vb, out, lse, ref, ref_lse

    # the training slice's shape: bf16 at batch 64 in one launch
    qt, kt, vt = _train_attn_inputs(dev, gen, 3)
    out, lse = attn_fast.fast_mha_forward(qt, kt, vt, n_real)
    ref, ref_lse = _per_batch(lambda q, k, v: attn_fast.mha_forward_reference(
        q.float(), k.float(), v.float(), n_real), qt, kt, vt)
    e_out64 = (out.float() - ref)[:, :, rows].abs().max().item()
    e_lse64 = (lse - ref_lse)[:, :, rows].abs().max().item()
    ms64 = float(np.median(cuda_times(lambda: attn_fast.fast_mha_forward(qt, kt, vt, n_real))))
    print(f"K2 attn_fwd bf16 at the train batch (B {TRAIN_BATCH}): out {e_out64:.3e} lse "
          f"{e_lse64:.3e} (<= {ATTN_BF16_ERR})  median kernel {ms64:.3f} ms", flush=True)
    require(e_out64 <= ATTN_BF16_ERR and e_lse64 <= ATTN_BF16_ERR,
            f"K2 bf16 disagrees at batch {TRAIN_BATCH}")
    return dict(max_abs_err=max(e_out, e_out64), ms=ms, plain_ms=plain, library_ms=lib, **bd)


def phase_attn_bwd(dev: torch.device, gen: torch.Generator) -> dict:
    """K2b at AST-Base shapes from K2f's residuals: f32 and bf16 at batch 8,
    timed against the plain version, then bf16 at the training slice's batch
    64, held against the plain version one batch row at a time."""
    B, H, N, dh, n_real = SERVE_BATCH, HEADS, N_PAD, 64, N_REAL
    q, k, v, do = (torch.randn(B, H, N, dh, generator=gen) for _ in range(4))
    q = q * dh**-0.5
    rows = slice(0, n_real)
    for dtype, tol in ((torch.float32, BWD_F32_ERR), (torch.bfloat16, BWD_BF16_ERR)):
        qd, kd, vd, dod = (t.to(dev, dtype) for t in (q, k, v, do))
        out, lse = attn_fast.fast_mha_forward(qd, kd, vd, n_real)
        got = attn_fast.fast_mha_backward(qd, kd, vd, out, lse, dod, n_real)
        want = attn_fast.mha_backward_reference(qd, kd, vd, out, lse, dod, n_real)
        errs = [norm_err(g[:, :, rows], w[:, :, rows]) for g, w in zip(got, want)]
        abs_err = max((g - w)[:, :, rows].float().abs().max().item() for g, w in zip(got, want))
        zero_tails = all((g[:, :, n_real:] == 0).all().item() for g in got[1:])
        finite = all(torch.isfinite(g).all().item() for g in got)
        del got, want
        ms, plain = paired_ms(
            lambda: attn_fast.fast_mha_backward(qd, kd, vd, out, lse, dod, n_real),
            lambda: attn_fast.mha_backward_reference(qd, kd, vd, out, lse, dod, n_real))
        name = str(dtype).removeprefix("torch.")
        print(f"K2b attn_bwd {name} (B {B}, H {H}, N {N}, dh {dh}, n_real {n_real}): "
              f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} normalised (<= {tol}), "
              f"max_abs {abs_err:.3e}, dK/dV rows >= n_real exactly 0: {zero_tails}  median "
              f"kernel {ms:.3f} ms  plain {plain:.3f} ms", flush=True)
        require(max(errs) <= tol and zero_tails and finite, f"K2b {name} disagrees")

    # yardstick on the bf16 inputs: SDPA's backward alone (autograd.grad of a
    # saved forward), and SDPA forward + backward
    mask = _key_mask(N, n_real, dev)
    qr, kr, vr = (t.detach().requires_grad_() for t in (qd, kd, vd))
    o = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask, scale=1.0)
    lib_bwd = float(np.median(cuda_times(
        lambda: torch.autograd.grad(o, (qr, kr, vr), dod, retain_graph=True))))
    lib_fb = float(np.median(cuda_times(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask, scale=1.0),
        (qr, kr, vr), dod))))
    bd = bound(10 * B * H * N * n_real * dh, BF16_TENSOR_FLOPS, _attn_bytes(B, H, N, dh, 8, 2))
    print(f"K2b attn_bwd bf16: SDPA backward alone {lib_bwd:.3f} ms, SDPA forward + backward "
          f"{lib_fb:.3f} ms; bound {bd['bound_ms']:.3f} ms ({bd['bound_by']})", flush=True)
    del q, k, v, do, qd, kd, vd, dod, out, lse, qr, kr, vr, o

    # the training slice's shape: bf16 at batch 64 in one launch
    qt, kt, vt, dot = _train_attn_inputs(dev, gen, 4)
    out, lse = attn_fast.fast_mha_forward(qt, kt, vt, n_real)
    got = attn_fast.fast_mha_backward(qt, kt, vt, out, lse, dot, n_real)
    want = _per_batch(lambda *t: attn_fast.mha_backward_reference(*t, n_real),
                      qt, kt, vt, out, lse, dot)
    errs = [norm_err(g[:, :, rows], w[:, :, rows]) for g, w in zip(got, want)]
    abs64 = max((g - w)[:, :, rows].float().abs().max().item() for g, w in zip(got, want))
    zero_tails = all((g[:, :, n_real:] == 0).all().item() for g in got[1:])
    finite = all(torch.isfinite(g).all().item() for g in got)
    del got, want
    ms64 = float(np.median(cuda_times(
        lambda: attn_fast.fast_mha_backward(qt, kt, vt, out, lse, dot, n_real))))
    print(f"K2b attn_bwd bf16 at the train batch (B {TRAIN_BATCH}): dq {errs[0]:.3e} dk "
          f"{errs[1]:.3e} dv {errs[2]:.3e} normalised (<= {BWD_BF16_ERR}), max_abs "
          f"{abs64:.3e}, dK/dV rows >= n_real exactly 0: {zero_tails}  median kernel "
          f"{ms64:.3f} ms", flush=True)
    require(max(errs) <= BWD_BF16_ERR and zero_tails and finite,
            f"K2b bf16 disagrees at batch {TRAIN_BATCH}")
    return dict(max_abs_err=max(abs_err, abs64), ms=ms, plain_ms=plain, library_ms=lib_bwd,
                **bd)


def _post(port: int, path: str, body: bytes) -> tuple[int, dict]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, body=body)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _check_probs(status: int, resp: dict, what: str) -> np.ndarray:
    require(status == 200, f"{what}: HTTP {status} {resp}")
    p = np.asarray(resp["probs"], np.float64)
    require(p.shape == (AST_BASE["num_classes"],) and np.isfinite(p).all()
            and abs(p.sum() - 1.0) <= PROB_SUM_ERR, f"{what}: bad probabilities")
    return p


def phase_slice(dev: torch.device, seed: int, tmp: Path, card: str) -> dict:
    rng = np.random.default_rng(seed)
    model = ASTModel(**AST_BASE, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(seed))
    pipe = DevicePipeline(PipelineConfig(mode="ast", num_classes=AST_BASE["num_classes"]))
    art = export_model(model, pipe, tmp / "artifact", batch=SERVE_BATCH, clip_samples=CLIP)
    clips = (rng.standard_normal((BURST + 1, CLIP)) * 0.1).astype(np.float32)
    wav_path = tmp / "clip.wav"
    W.write_wav(wav_path, clips[-1], AST_BASE["sample_rate"])

    # --- the main path: only these launches are counted ---------------------
    _reset_launches()
    t0 = time.perf_counter()
    server = ModelServer(art, device="cuda", window_ms=20.0)
    httpd = server.make_http_server("127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        t_load = time.perf_counter() - t0
        bodies = [("/predict_raw", json.dumps({"pcm": c.tolist(),
                                               "sample_rate": AST_BASE["sample_rate"]}).encode())
                  for c in clips[:BURST]]
        bodies.append(("/predict", wav_path.read_bytes()))
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(bodies)) as ex:
            answers = list(ex.map(lambda pb: _post(port, *pb), bodies))
        t_burst = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    batches = server.batcher.batches
    counts = _launch_counts()
    k1, k2, k2b = counts["k1"], counts["k2f"], counts["k2b"]
    # --------------------------------------------------------------------------
    probs = [_check_probs(s, r, f"request {i}") for i, (s, r) in enumerate(answers)]
    print(f"served {len(answers)} requests ({BURST} /predict_raw + 1 /predict) in "
          f"{t_burst:.3f} s after {t_load:.3f} s of load + warm-up; {batches} device "
          f"batches of {SERVE_BATCH}; launches K1 {k1} K2 {k2} K2b {k2b}", flush=True)
    require(batches >= 1 + -(-len(bodies) // SERVE_BATCH), f"only {batches} device batches")
    require(k1 == batches and k2 == DEPTH * batches and k2b == 0
            and counts["gmm"] == counts["tgmm"] == 0,
            f"launch counts {counts} for {batches} device batches")
    direct = server.serve(np.pad(clips[:1] / np.abs(clips[0]).max(),
                                 ((0, SERVE_BATCH - 1), (0, 0))))[0]
    e_direct = float(np.abs(direct - probs[0]).max())
    print(f"HTTP answer vs direct call on the same clip: {e_direct:.3e} (<= {PROB_SUM_ERR})",
          flush=True)
    require(e_direct <= PROB_SUM_ERR, "HTTP answer differs from the direct call")

    # --- one fixed batch against the same weights with plain ops in f32 -------
    served = server.serve.model
    wave = torch.from_numpy(clips[:SERVE_BATCH]).to(dev)
    feats_plain = M.ast_normalize(M.log_mel_spectrogram(wave))
    ref32 = ASTModel(**AST_BASE, dtype=torch.float32)
    ref32.load_state_dict(served.state_dict())
    ref32.to(dev)
    with torch.inference_mode():
        want = ref32(feats_plain, attention=attn_fast.mha_forward_reference)
        got32 = ref32(pipe.eval_batch(wave))
        got16 = served(pipe.eval_batch(wave))
    e32 = (got32 - want).abs().max().item()
    e16 = (got16 - want).abs().max().item()
    require(torch.isfinite(got16).all().item() and got16.shape == want.shape,
            "served outputs not finite or misshaped")
    print(f"slice pre-softmax (sigmoid) outputs vs plain ops in f32, batch {SERVE_BATCH}: "
          f"kernels f32 {e32:.3e} (<= {SLICE_F32_ERR}), served bf16 {e16:.3e} "
          f"(<= {SLICE_BF16_ERR})", flush=True)
    require(e32 <= SLICE_F32_ERR, "f32 slice through the kernels disagrees with plain ops")
    require(e16 <= SLICE_BF16_ERR, "bf16 served slice disagrees with plain ops")
    del ref32

    # --- serving latency and throughput ---------------------------------------
    one = clips[:1]
    for _ in range(3):
        server.serve(one)
    lat = []
    for _ in range(LATENCY_SAMPLES):
        t0 = time.perf_counter()
        server.serve(one)
        lat.append((time.perf_counter() - t0) * 1e3)
    print(f"serving latency, batch 1 (host clock, wave in and probs out): median "
          f"{np.median(lat):.3f} ms, p90 {np.percentile(lat, 90):.3f} ms over "
          f"{LATENCY_SAMPLES}  [{card}]", flush=True)
    infer = make_infer(served, server.serve.pipe)
    for b in (SERVE_BATCH, 64):
        wave = (torch.randn(b, CLIP, generator=torch.Generator().manual_seed(seed)) * 0.1).to(dev)
        ms = float(np.median(cuda_times(lambda: infer(wave), iters=10)))
        print(f"serving throughput, batch {b} (device-resident waves, CUDA events, median "
              f"of 10): {ms:.3f} ms/batch, {b / ms * 1e3:.1f} clips/s  [{card}]", flush=True)
    return counts


def phase_train(dev: torch.device, seed: int, card: str) -> dict:
    """The training slice at the bench's configuration, batch 64."""
    step, state, ms, wave, labels = bench.build(TRAIN_BATCH, seed, dev)
    before = [p.detach().clone() for p in state.model.parameters()]
    torch.cuda.reset_peak_memory_stats(dev)

    # --- the main path: only these launches are counted ---------------------
    _reset_launches()
    state, ms, losses, step_s = bench.timed_steps(step, state, ms, wave, labels,
                                                  WARMUP_STEPS, TIMED_STEPS)
    counts = _launch_counts()
    k1, k2f, k2b = counts["k1"], counts["k2f"], counts["k2b"]
    # --------------------------------------------------------------------------
    n = WARMUP_STEPS + TIMED_STEPS
    peak_mem = torch.cuda.max_memory_allocated(dev) / 2**30
    params = list(state.model.parameters())
    unchanged = [i for i, (a, p) in enumerate(zip(before, params)) if torch.equal(a, p)]
    del before
    prof = bench.profile_steps(step, state, ms, wave, labels)
    rec = bench.record(state.model, TRAIN_BATCH, step_s, losses, peak_mem, prof)
    print(f"train: AST-Base bf16 remat attn_res, batch {TRAIN_BATCH}, {WARMUP_STEPS} warm-up + "
          f"{TIMED_STEPS} timed steps: {rec['step_ms']:.3f} ms/step, {rec['value']:.2f} "
          f"clips/s, MFU {rec['mfu']:.4f} (hw_util {rec['hw_util']:.4f}), peak memory "
          f"{rec['peak_mem_gib']:.2f} GiB; losses {losses[0]:.4f} .. {losses[-1]:.4f}; "
          f"launches per step K1 {k1 / n:g} K2f {k2f / n:g} K2b {k2b / n:g}; profiled: "
          f"busy share {prof['busy_share']:.3f}, K2f {rec['decomp']['attn_fwd_ms']:.1f} + K2b "
          f"{rec['decomp']['attn_bwd_ms']:.1f} ms of {prof['device_ms_per_step']:.1f} ms "
          f"device time per step  [{card}]", flush=True)
    print(json.dumps(rec), flush=True)
    require(not unchanged, f"{len(unchanged)} of {len(params)} parameters did not change")
    require((k1, k2f, k2b, counts["gmm"], counts["tgmm"]) == (n, DEPTH * n, DEPTH * n, 0, 0),
            f"launch counts {counts} over {n} steps")
    return counts


def phase_parity(dev: torch.device, seed: int) -> None:
    """One train step at full width and batch 4, the same weights and draws:
    f32 through the kernels vs f32 with plain attention, and bf16 through
    the kernels (remat attn_res) vs that f32 plain step. SGD with momentum,
    so the momentum buffer after one step is each parameter's (clipped)
    gradient; Adam's first update, lr x g / (|g| + eps), is near lr x sign(g)
    and would hide the gradient's error where |g| is large."""
    pipe = bench.bench_pipeline()
    rng = np.random.default_rng(seed + 1)
    wave = torch.from_numpy((rng.standard_normal((PARITY_BATCH, CLIP)) * 0.3)
                            .astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, AST_BASE["num_classes"], PARITY_BATCH)).to(dev)
    draws = pipe.draw(PARITY_BATCH, CLIP, rng)

    def one_step(dtype, remat, attention):
        model = ASTModel(**AST_BASE, dtype=dtype, remat=remat, device=dev,
                         generator=torch.Generator().manual_seed(seed))
        state = TrainState.create(model, sgd(lr=5e-4, momentum=0.9), None, 25,
                                  gradient_clip_val=1.0)
        step = make_train_step(pipe, CrossEntropyLoss(), attention=attention)
        attn_fast.reset_launches()
        _, _, loss = step(state, MetricState.create(AST_BASE["num_classes"], dev),
                          wave, labels, draws)
        torch.cuda.synchronize()
        names, params = zip(*model.named_parameters())
        return (loss.item(), [state.optimizer.state[p]["momentum_buffer"] for p in params],
                [p.detach() for p in params], (attn_fast.launches, attn_fast.bwd_launches),
                names)

    k32 = one_step(torch.float32, False, None)
    p32 = one_step(torch.float32, False, attn_fast.mha_forward_reference)
    b16 = one_step(torch.bfloat16, True, None)
    require(k32[3] == (DEPTH, DEPTH) and p32[3] == (0, 0) and b16[3] == (DEPTH, DEPTH),
            f"parity launches {k32[3]} {p32[3]} {b16[3]}")

    _compare_steps(k32, p32, "f32 kernels vs f32 plain attention (AST-Base", STEP_F32_LOSS,
                   STEP_F32_GRAD)
    _compare_steps(b16, p32, "bf16 kernels (remat attn_res) vs f32 plain attention (AST-Base",
                   STEP_BF16_LOSS, STEP_BF16_GRAD)


def _compare_steps(got, want, what: str, loss_tol: float, tol: float,
                   required: bool = True) -> tuple[float, float, float]:
    """Loss (relative), gradients (momentum buffers) and parameters after the
    update (normalised per parameter) of two one-step runs; a gradient that
    is exactly 0 on the reference side must be exactly 0 on the other.
    Raises past the bounds when ``required``; returns the three errors."""
    e_loss = abs(got[0] - want[0]) / abs(want[0])
    grad_errs = sorted(((norm_err(a, b), name) for a, b, name in zip(got[1], want[1], got[4])
                        if b.abs().max() > 0), reverse=True)
    e_grad = grad_errs[0][0]
    zero_same = all((a == 0).all().item() for a, b in zip(got[1], want[1])
                    if b.abs().max() == 0)
    e_param = max(norm_err(a, b) for a, b in zip(got[2], want[2]))
    worst = ", ".join(f"{name} {e:.2e}" for e, name in grad_errs[:3])
    print(f"step parity, {what}, batch {PARITY_BATCH}, one SGD step): loss {got[0]:.6f} vs "
          f"{want[0]:.6f}, rel {e_loss:.3e} (<= {loss_tol}); gradients {e_grad:.3e} (largest: "
          f"{worst}), parameters after the update {e_param:.3e}, normalised per parameter (<= "
          f"{tol}); zero gradients the same: {zero_same}"
          f"{'' if required else '  [not a bound: printed only]'}", flush=True)
    if required:
        require(e_loss <= loss_tol and e_grad <= tol and zero_same and e_param <= tol,
                f"step parity {what}")
    return e_loss, e_grad, e_param


def phase_attn_ast_moe(dev: torch.device, gen: torch.Generator) -> dict:
    """K2f and K2b at AST-MoE's training shape, (64, 6, 768, 64) bf16,
    n_real 689 (12 query tiles of 64, the boundary tile at 640-703), held
    against the plain versions one batch row at a time."""
    H, N, n_real = MOE_HEADS, MOE_N_PAD, MOE_N_REAL
    q, k, v, do = _train_attn_inputs(dev, gen, 4, H, N)
    rows = slice(0, n_real)
    out, lse = attn_fast.fast_mha_forward(q, k, v, n_real)
    ref, ref_lse = _per_batch(lambda q, k, v: attn_fast.mha_forward_reference(
        q.float(), k.float(), v.float(), n_real), q, k, v)
    e_out = (out.float() - ref)[:, :, rows].abs().max().item()
    e_lse = (lse - ref_lse)[:, :, rows].abs().max().item()
    del ref, ref_lse
    got = attn_fast.fast_mha_backward(q, k, v, out, lse, do, n_real)
    want = _per_batch(lambda *t: attn_fast.mha_backward_reference(*t, n_real),
                      q, k, v, out, lse, do)
    errs = [norm_err(g[:, :, rows], w[:, :, rows]) for g, w in zip(got, want)]
    abs_err = max((g - w)[:, :, rows].float().abs().max().item() for g, w in zip(got, want))
    zero_tails = all((g[:, :, n_real:] == 0).all().item() for g in got[1:])
    finite = all(torch.isfinite(g).all().item() for g in (out, *got))
    del got, want
    fwd_ms = float(np.median(cuda_times(lambda: attn_fast.fast_mha_forward(q, k, v, n_real))))
    bwd_ms = float(np.median(cuda_times(
        lambda: attn_fast.fast_mha_backward(q, k, v, out, lse, do, n_real))))
    print(f"K2 at AST-MoE's train shape (B {TRAIN_BATCH}, H {H}, N {N}, dh 64, n_real {n_real}) "
          f"bf16: attn_fwd out {e_out:.3e} lse {e_lse:.3e} (<= {ATTN_BF16_ERR}), median "
          f"{fwd_ms:.3f} ms; attn_bwd dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
          f"normalised (<= {BWD_BF16_ERR}), max_abs {abs_err:.3e}, dK/dV rows >= n_real exactly "
          f"0: {zero_tails}, median {bwd_ms:.3f} ms", flush=True)
    require(e_out <= ATTN_BF16_ERR and e_lse <= ATTN_BF16_ERR, "K2f disagrees at AST-MoE's shape")
    require(max(errs) <= BWD_BF16_ERR and zero_tails and finite,
            "K2b disagrees at AST-MoE's shape")
    return dict(fwd_ms=fwd_ms, fwd_err=max(e_out, e_lse), bwd_ms=bwd_ms, bwd_err=abs_err)


def _router_group_sizes(dev: torch.device, seed: int) -> torch.Tensor:
    """The group sizes of a real router draw at batch 64: block 0 of AST-MoE
    (bf16, seeded weights) on 64 seeded clips, read as the model hands them
    to the grouped matmul."""
    model = ASTMoE(**AST_MOE, generator=torch.Generator().manual_seed(seed), device=dev)
    wave = (torch.randn(TRAIN_BATCH, CLIP, generator=torch.Generator().manual_seed(seed + 3))
            * 0.3).to(dev)
    seen = []

    def recording(lhs, rhs, group_sizes):
        seen.append(group_sizes.clone())
        return gmm_ops.gmm(lhs, rhs, group_sizes)

    with torch.inference_mode():
        model(bench.bench_pipeline().eval_batch(wave), grouped_matmul=recording)
    return seen[0]


def _library_ms(fn) -> tuple[float | None, str]:
    """Median ms of a PyTorch yardstick call, or None and why it refused."""
    try:
        return float(np.median(cuda_times(fn))), ""
    except (RuntimeError, TypeError, ValueError, AttributeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def phase_gmm(dev: torch.device, gen: torch.Generator, seed: int) -> tuple[dict, dict]:
    """K4a and K4b against their plain versions at AST-MoE's batch-64 shapes:
    gmm1 x @ wi and gmm2 h @ wo (forward), their transposed-rhs dlhs, and
    tgmm for dwi and dwo; bf16 with a real router draw's group sizes and
    with a skewed set, f32 for gmm1 and tgmm1 on the router draw."""
    E, D, Fd, M = AST_MOE["n_experts"], MOE_DIM, MOE_FF, MOE_ROWS
    real = _router_group_sizes(dev, seed)
    require(int(real.sum()) == M, f"router draw has {int(real.sum())} rows, not {M}")
    sets = {"router draw": real,
            "skewed": torch.tensor(SKEWED_SIZES, dtype=torch.int32, device=dev)}
    g = torch.Generator(dev).manual_seed(int(torch.randint(2**31, (1,), generator=gen)))

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    x, h, gy, gh = randn(M, D), randn(M, Fd), randn(M, D), randn(M, Fd)
    wi, wo = randn(E, D, Fd, scale=D**-0.5), randn(E, Fd, D, scale=Fd**-0.5)
    flops = 2.0 * M * D * Fd
    nbytes = 2.0 * (M * D + M * Fd + E * D * Fd)   # every product: its two inputs and its output
    bd = bound(flops, BF16_TENSOR_FLOPS, nbytes)

    def products(gs):
        offs = torch.cumsum(gs, 0, dtype=torch.int32)
        G, T = gmm_ops, True
        # name: (kernel, plain, library yardstick)
        return {
            "gmm1 x @ wi": (lambda: G.gmm(x, wi, gs), lambda: G.gmm_reference(x, wi, gs),
                            lambda: torch._grouped_mm(x, wi, offs=offs)),
            "gmm2 h @ wo": (lambda: G.gmm(h, wo, gs), lambda: G.gmm_reference(h, wo, gs),
                            lambda: torch._grouped_mm(h, wo, offs=offs)),
            "dlhs1 dh @ wi^T": (lambda: G.gmm(gh, wi, gs, T),
                                lambda: G.gmm_reference(gh, wi, gs, T),
                                lambda: torch._grouped_mm(gh, wi.transpose(1, 2), offs=offs)),
            "dlhs2 dy @ wo^T": (lambda: G.gmm(gy, wo, gs, T),
                                lambda: G.gmm_reference(gy, wo, gs, T),
                                lambda: torch._grouped_mm(gy, wo.transpose(1, 2), offs=offs)),
            "tgmm1 x^T dh": (lambda: G.tgmm(x, gh, gs), lambda: G.tgmm_reference(x, gh, gs),
                             lambda: torch._grouped_mm(x.t(), gh, offs=offs)),
            "tgmm2 h^T dy": (lambda: G.tgmm(h, gy, gs), lambda: G.tgmm_reference(h, gy, gs),
                             lambda: torch._grouped_mm(h.t(), gy, offs=offs)),
        }

    results, max_abs = {}, {"gmm": 0.0, "tgmm": 0.0}
    for set_name, gs in sets.items():
        sizes = gs.tolist()
        print(f"K4 group sizes, {set_name}: {sizes} (largest {max(sizes) / (M / E):.2f} x the "
              f"mean)", flush=True)
        for name, (kernel, plain, lib) in products(gs).items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err, abs_err = norm_err(got, want), (got.float() - want.float()).abs().max().item()
            finite = torch.isfinite(got).all().item()
            del got, want
            ms, plain_ms = paired_ms(kernel, plain)
            lib_ms, why = _library_ms(lib)
            lib_err = None
            if lib_ms is not None:
                lib_err = norm_err(lib(), plain())
            key = "tgmm" if name.startswith("tgmm") else "gmm"
            max_abs[key] = max(max_abs[key], abs_err)
            results[(set_name, name)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                             norm_err=err, max_abs_err=abs_err)
            lib_txt = (f"{lib_ms:.3f} ms (its own error {lib_err:.1e})" if lib_ms is not None
                       else f"null ({why})")
            print(f"K4 {key} bf16 {name}, {set_name}: norm_err {err:.3e} (<= {GMM_BF16_ERR}), max_abs {abs_err:.3e}  median kernel "
                  f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s)  plain {plain_ms:.3f} ms  "
                  f"torch._grouped_mm {lib_txt}; bound {bd['bound_ms']:.3f} ms "
                  f"({bd['bound_by']})", flush=True)
            require(err <= GMM_BF16_ERR and finite, f"K4 {name} bf16 disagrees ({set_name})")

    # f32 at one shape: the scalar path, summation order only
    x32, wi32, gh32 = x.float(), wi.float(), gh.float()
    for name, kernel, plain in (
            ("gmm1 x @ wi", lambda: gmm_ops.gmm(x32, wi32, real),
             lambda: gmm_ops.gmm_reference(x32, wi32, real)),
            ("tgmm1 x^T dh", lambda: gmm_ops.tgmm(x32, gh32, real),
             lambda: gmm_ops.tgmm_reference(x32, gh32, real))):
        err = norm_err(kernel(), plain())
        ms = float(np.median(cuda_times(kernel)))
        print(f"K4 f32 {name}, router draw: norm_err {err:.3e} (<= {GMM_F32_ERR})  median "
              f"kernel {ms:.3f} ms", flush=True)
        require(err <= GMM_F32_ERR, f"K4 {name} f32 disagrees")
    del x32, wi32, gh32

    def entry(key, name):
        r = results[("router draw", name)]
        return dict(max_abs_err=max_abs[key], norm_err=r["norm_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], library_ms=r["library_ms"], **bd,
                    ms_by_product={f"{n} ({sn})": v["ms"] for (sn, n), v in results.items()
                                   if (n.startswith("tgmm")) == (key == "tgmm")})

    return entry("gmm", "gmm1 x @ wi"), entry("tgmm", "tgmm1 x^T dh")


def _plain_ops() -> dict:
    return dict(attention=attn_fast.mha_forward_reference, grouped_matmul=gmm_ops.gmm_reference)


def phase_moe_slice(dev: torch.device, seed: int, tmp: Path, card: str) -> dict:
    """AST-MoE serving: export (bf16, seeded weights), load on the card,
    serve one batch of 8 clips; then the same batch against the weights in
    f32 with plain attention and plain grouped matmul, on the routes of the
    run under test; then throughput at batch 8 and 64."""
    rng = np.random.default_rng(seed + 4)
    model = ASTMoE(**AST_MOE, generator=torch.Generator().manual_seed(seed))
    pipe = DevicePipeline(PipelineConfig(mode="ast", num_classes=AST_MOE["num_classes"]))
    art = export_model(model, pipe, tmp / "ast_moe", batch=SERVE_BATCH, clip_samples=CLIP)
    del model
    clips = (rng.standard_normal((SERVE_BATCH, CLIP)) * 0.1).astype(np.float32)
    serve = load_exported(art, device="cuda")
    serve(clips)   # warm-up: cuBLAS handles, allocator

    # --- the main path: only these launches are counted ---------------------
    _reset_launches()
    probs = serve(clips)
    torch.cuda.synchronize()
    counts = _launch_counts()
    # --------------------------------------------------------------------------
    print(f"AST-MoE served one batch of {SERVE_BATCH}: launches {counts}", flush=True)
    require(probs.shape == (SERVE_BATCH, AST_MOE["num_classes"]) and np.isfinite(probs).all()
            and np.abs(probs.sum(-1) - 1.0).max() <= PROB_SUM_ERR,
            "AST-MoE probabilities not finite, misshaped or not summing to 1")
    require(counts == dict(k1=1, k2f=DEPTH, k2b=0, gmm=2 * DEPTH, tgmm=0),
            f"AST-MoE serving launch counts {counts} for one device batch")

    # --- the batch against plain ops in f32, on the same routes ---------------
    served = serve.model
    wave = torch.from_numpy(clips).to(dev)
    feats_plain = M.ast_normalize(M.log_mel_spectrogram(wave))
    feats = pipe.eval_batch(wave)
    ref32 = ASTViT(**{**served.config, "dtype": "float32"})
    ref32.load_state_dict(served.state_dict())
    ref32.to(dev)
    r32, r16, r_free = RouteLog(), RouteLog(), RouteLog()
    with torch.inference_mode():
        got32 = ref32(feats, topk=r32.record)
        want32 = ref32(feats_plain, topk=r32.replay(DEPTH), **_plain_ops())
        got16 = served(feats, topk=r16.record)
        want16 = ref32(feats_plain, topk=r16.replay(DEPTH), **_plain_ops())
        free = ref32(feats_plain, topk=r_free.record, **_plain_ops())
    e32 = (got32 - want32).abs().max().item()
    e16 = (got16 - want16).abs().max().item()
    e_free = (got16 - free).abs().max().item()
    flips = r16.flips(r_free, MOE_N_REAL)
    require(torch.isfinite(got16).all().item() and got16.shape == want16.shape,
            "AST-MoE served outputs not finite or misshaped")
    print(f"AST-MoE pre-softmax (sigmoid) outputs vs plain ops in f32 on the same routes, batch "
          f"{SERVE_BATCH}: kernels f32 {e32:.3e} (<= {SLICE_F32_ERR}), served bf16 {e16:.3e} "
          f"(<= {SLICE_BF16_ERR}); a free f32 plain run flips {flips[0]} of {flips[1]} routes "
          f"of the bf16 run, which moves the outputs by {e_free:.3e}", flush=True)
    require(e32 <= SLICE_F32_ERR, "AST-MoE f32 through the kernels disagrees with plain ops")
    require(e16 <= SLICE_BF16_ERR, "AST-MoE bf16 served outputs disagree with plain ops")
    del ref32

    infer = make_infer(served, serve.pipe)
    for b in (SERVE_BATCH, 64):
        wave = (torch.randn(b, CLIP, generator=torch.Generator().manual_seed(seed)) * 0.1).to(dev)
        ms = float(np.median(cuda_times(lambda: infer(wave), iters=10)))
        prof = bench.profile_calls(lambda: infer(wave), n=3, top=8)
        host = {k: round(v["ms"], 3) for k, v in prof["host_self_cpu_ms"].items()}
        print(f"AST-MoE serving throughput, batch {b} (device-resident waves, CUDA events, "
              f"median of 10): {ms:.3f} ms/batch, {b / ms * 1e3:.1f} clips/s; profiled: "
              f"{prof['device_ms_per_call']:.1f} ms of kernels ({prof['kernels_per_call']:.0f} "
              f"launches) in {prof['wall_ms_per_call']:.1f} ms, busy share "
              f"{prof['busy_share']:.3f}, kinds {dict((k, round(v, 2)) for k, v in prof['by_kind_ms'].items())}, "
              f"host self CPU ms {host}  [{card}]", flush=True)
    return counts


def phase_moe_train(dev: torch.device, seed: int, card: str) -> dict:
    """AST-MoE training at ``scripts/bench.py --model ast_moe``'s
    configuration, batch 64."""
    step, state, ms, wave, labels = bench.build(TRAIN_BATCH, seed, dev, "ast_moe")
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    torch.cuda.reset_peak_memory_stats(dev)

    # --- the main path: only these launches are counted ---------------------
    _reset_launches()
    state, ms, losses, step_s = bench.timed_steps(step, state, ms, wave, labels,
                                                  WARMUP_STEPS, TIMED_STEPS)
    counts = _launch_counts()
    # --------------------------------------------------------------------------
    n = WARMUP_STEPS + TIMED_STEPS
    peak_mem = torch.cuda.max_memory_allocated(dev) / 2**30
    named = dict(state.model.named_parameters())
    unchanged = [k for k, p in named.items() if torch.equal(before[k], p)]
    # every expert of every block: each (E, ...) slice of the expert tensors
    experts = [(k, e) for k, p in named.items() if k.split(".")[-1] in ("wi", "bi", "wo", "bo")
               for e in range(p.shape[0]) if torch.equal(before[k][e], p[e])]
    del before
    prof = bench.profile_steps(step, state, ms, wave, labels)
    rec = bench.record(state.model, TRAIN_BATCH, step_s, losses, peak_mem, prof)
    means = {k: round(v.item(), 4) for k, v in ms.extra_means().items()}
    dec = rec["decomp"]
    print(f"train: AST-MoE bf16 remat attn_res dropout 0.1, batch {TRAIN_BATCH}, {WARMUP_STEPS} "
          f"warm-up + {TIMED_STEPS} timed steps: {rec['step_ms']:.3f} ms/step, "
          f"{rec['value']:.2f} clips/s, MFU {rec['mfu']:.4f} (hw_util {rec['hw_util']:.4f}), "
          f"peak memory {rec['peak_mem_gib']:.2f} GiB; losses {losses[0]:.4f} .. "
          f"{losses[-1]:.4f}; MoE stats {means}; launches per step "
          f"{ {k: v / n for k, v in counts.items()} }; profiled: busy share "
          f"{prof['busy_share']:.3f}, K2f {dec['attn_fwd_ms']:.1f} + K2b {dec['attn_bwd_ms']:.1f}"
          f" + K4a {dec['gmm_ms']:.1f} + K4b {dec['tgmm_ms']:.1f} ms of "
          f"{prof['device_ms_per_step']:.1f} ms device time per step  [{card}]", flush=True)
    print(json.dumps(rec), flush=True)
    require(not unchanged, f"parameters that did not change: {unchanged[:8]}")
    require(not experts, f"experts whose weights did not change: {experts[:8]}")
    require(counts == dict(k1=n, k2f=DEPTH * n, k2b=DEPTH * n, gmm=6 * DEPTH * n,
                           tgmm=2 * DEPTH * n),
            f"AST-MoE launch counts {counts} over {n} steps")
    return counts


def phase_moe_parity(dev: torch.device, seed: int) -> None:
    """One AST-MoE train step at full width and batch 4, dropout 0.1 with one
    seed on every side, SGD with momentum (see ``phase_parity``): f32 through
    the kernels vs f32 plain ops, and bf16 through the kernels (remat
    attn_res) vs f32 plain ops, each plain run replaying the routes of the
    run it is compared with."""
    pipe = bench.bench_pipeline()
    rng = np.random.default_rng(seed + 2)
    wave = torch.from_numpy((rng.standard_normal((PARITY_BATCH, CLIP)) * 0.3)
                            .astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, AST_MOE["num_classes"], PARITY_BATCH)).to(dev)
    draws = pipe.draw(PARITY_BATCH, CLIP, rng)
    dropout_seed = int(rng.integers(2**62))

    def one_step(dtype, remat, plain, topk):
        model = ASTMoE(**AST_MOE, dtype=dtype, remat=remat, device=dev,
                       generator=torch.Generator().manual_seed(seed))
        state = TrainState.create(model, sgd(lr=5e-4, momentum=0.9), None, 25,
                                  gradient_clip_val=1.0)
        step = make_train_step(pipe, CrossEntropyLoss(), topk=topk,
                               **(_plain_ops() if plain else {}))
        _reset_launches()
        _, _, loss = step(state, MetricState.create(AST_MOE["num_classes"], dev, MOE_METRICS),
                          wave, labels, draws, dropout_seed)
        torch.cuda.synchronize()
        names, params = zip(*model.named_parameters())
        return (loss.item(), [state.optimizer.state[p]["momentum_buffer"] for p in params],
                [p.detach() for p in params], _launch_counts(), names)

    r32, r16 = RouteLog(), RouteLog()
    k32 = one_step(torch.float32, False, False, r32.record)
    p32 = one_step(torch.float32, False, True, r32.replay(DEPTH))
    b16 = one_step(torch.bfloat16, True, False, r16.record)
    p16 = one_step(torch.float32, False, True, r16.replay(DEPTH))
    zero = dict(k1=1, k2f=0, k2b=0, gmm=0, tgmm=0)
    require(k32[3] == dict(k1=1, k2f=DEPTH, k2b=DEPTH, gmm=4 * DEPTH, tgmm=2 * DEPTH)
            and b16[3] == dict(k1=1, k2f=DEPTH, k2b=DEPTH, gmm=6 * DEPTH, tgmm=2 * DEPTH)
            and p32[3] == zero and p16[3] == zero,
            f"AST-MoE parity launches {k32[3]} {p32[3]} {b16[3]} {p16[3]}")
    flips = r16.flips(r32, MOE_N_REAL)
    print(f"AST-MoE step parity: the bf16 run routes {flips[0]} of {flips[1]} real (token, "
          f"choice) pairs otherwise than the f32 run", flush=True)
    _compare_steps(k32, p32, "f32 kernels vs f32 plain attention and gmm, same routes "
                   "(AST-MoE, dropout 0.1", STEP_F32_LOSS, STEP_F32_GRAD)
    _compare_steps(b16, p16, "bf16 kernels (remat attn_res) vs f32 plain ops, same routes "
                   "(AST-MoE, dropout 0.1", STEP_BF16_LOSS, STEP_BF16_GRAD)
    _compare_steps(b16, p32, "bf16 kernels vs f32 plain ops on the f32 run's own routes "
                   "(AST-MoE, dropout 0.1", STEP_BF16_LOSS, STEP_BF16_GRAD, required=False)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # phase 0: start-up
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; "
                           "this script needs an NVIDIA GPU")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False   # the patch conv would run in TF32
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    names = ("mel_power", "attn_fwd", "attn_bwd", "gmm")
    _kernels.build(*names)   # one nvcc per source, all started together
    for name in names:
        _kernels.load(name)
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc: {', '.join(f'{k} {v:.2f} s' for k, v in _kernels.build_seconds.items())}) "
          f"torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    peak_tflops(torch.cuda.get_device_name(dev))   # the MFU needs a known card: fail early

    gen = torch.Generator().manual_seed(args.seed)
    k1 = phase_mel(dev, gen)
    k2f = phase_attn(dev, gen)
    k2b = phase_attn_bwd(dev, gen)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        serve = phase_slice(dev, args.seed, Path(tmp), card)
    torch.cuda.empty_cache()
    train = phase_train(dev, args.seed, card)
    torch.cuda.empty_cache()
    phase_parity(dev, args.seed)
    torch.cuda.empty_cache()
    k2_moe = phase_attn_ast_moe(dev, gen)
    torch.cuda.empty_cache()
    k4a, k4b = phase_gmm(dev, gen, args.seed)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        moe_serve = phase_moe_slice(dev, args.seed, Path(tmp), card)
    torch.cuda.empty_cache()
    moe_train = phase_moe_train(dev, args.seed, card)
    torch.cuda.empty_cache()
    phase_moe_parity(dev, args.seed)

    # launches: the training runs' (AST-Base + AST-MoE); launches_serving: the
    # serving runs'; launches_by_path: each main path's run, counted from 0
    paths = dict(ast_train=train, ast_serve=serve, ast_moe_train=moe_train,
                 ast_moe_serve=moe_serve)

    def launches(key):
        by_path = {p: c[key] for p, c in paths.items()}
        return dict(launches=by_path["ast_train"] + by_path["ast_moe_train"],
                    launches_serving=by_path["ast_serve"] + by_path["ast_moe_serve"],
                    launches_by_path=by_path)

    kernels = [
        dict(name="mel_power", route="cuda", source="dlsc_tpu_torch/csrc/mel_power.cu",
             replaces="dlsc_tpu/ops/mel_pallas.py:77", **launches("k1"), **k1),
        dict(name="attn_fwd", route="cuda", source="dlsc_tpu_torch/csrc/attn_fwd.cu",
             replaces="dlsc_tpu/ops/attn_fast.py:125", **launches("k2f"), **k2f,
             ms_ast_moe=k2_moe["fwd_ms"], max_abs_err_ast_moe=k2_moe["fwd_err"]),
        dict(name="attn_bwd", route="cuda", source="dlsc_tpu_torch/csrc/attn_bwd.cu",
             replaces="dlsc_tpu/ops/attn_fast.py:205", **launches("k2b"), **k2b,
             ms_ast_moe=k2_moe["bwd_ms"], max_abs_err_ast_moe=k2_moe["bwd_err"]),
        dict(name="gmm", route="cuda", source="dlsc_tpu_torch/csrc/gmm.cu",
             replaces="dlsc_tpu/models/moe.py:537", **launches("gmm"), **k4a),
        dict(name="tgmm", route="cuda", source="dlsc_tpu_torch/csrc/gmm.cu",
             replaces="jax/experimental/pallas/ops/tpu/megablox/gmm.py:573",
             **launches("tgmm"), **k4b),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
