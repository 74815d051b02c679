#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dlsc_tpu_torch) of AST-Base serving and training on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own lines; any failure raises (exit code != 0):

0. start-up: require CUDA, print the card's name and power limit, turn TF32
   off for matmuls and cuDNN, build the three kernels from csrc/ (one nvcc
   each, all at once);
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
   kernels (remat ``attn_res``) vs that f32 plain step.

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
from dlsc_tpu_torch.ops import attn_fast, mel_kernel
from dlsc_tpu_torch.ops import mel as M
from dlsc_tpu_torch.scripts import bench
from dlsc_tpu_torch.server import ModelServer
from dlsc_tpu_torch.serving import export_model, make_infer
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


def _train_attn_inputs(dev: torch.device, gen: torch.Generator, n_tensors: int) -> list:
    """``n_tensors`` bf16 (TRAIN_BATCH, HEADS, N_PAD, 64) tensors, the first
    (q) pre-scaled, drawn on the card from a seed taken from ``gen``."""
    g = torch.Generator(dev).manual_seed(int(torch.randint(2**31, (1,), generator=gen)))
    ts = [torch.randn(TRAIN_BATCH, HEADS, N_PAD, 64, generator=g, device=dev)
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
    mel_kernel.reset_launches()
    attn_fast.reset_launches()
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
    k1, k2, k2b = mel_kernel.launches, attn_fast.launches, attn_fast.bwd_launches
    # --------------------------------------------------------------------------
    probs = [_check_probs(s, r, f"request {i}") for i, (s, r) in enumerate(answers)]
    print(f"served {len(answers)} requests ({BURST} /predict_raw + 1 /predict) in "
          f"{t_burst:.3f} s after {t_load:.3f} s of load + warm-up; {batches} device "
          f"batches of {SERVE_BATCH}; launches K1 {k1} K2 {k2} K2b {k2b}", flush=True)
    require(batches >= 1 + -(-len(bodies) // SERVE_BATCH), f"only {batches} device batches")
    require(k1 == batches and k2 == DEPTH * batches and k2b == 0,
            f"launch counts K1 {k1} K2 {k2} K2b {k2b} for {batches} device batches")
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
    return dict(k1=k1, k2=k2, k2b=k2b)


def phase_train(dev: torch.device, seed: int, card: str) -> dict:
    """The training slice at the bench's configuration, batch 64."""
    step, state, ms, wave, labels = bench.build(TRAIN_BATCH, seed, dev)
    before = [p.detach().clone() for p in state.model.parameters()]
    torch.cuda.reset_peak_memory_stats(dev)

    # --- the main path: only these launches are counted ---------------------
    mel_kernel.reset_launches()
    attn_fast.reset_launches()
    state, ms, losses, step_s = bench.timed_steps(step, state, ms, wave, labels,
                                                  WARMUP_STEPS, TIMED_STEPS)
    k1, k2f, k2b = mel_kernel.launches, attn_fast.launches, attn_fast.bwd_launches
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
    require((k1, k2f, k2b) == (n, DEPTH * n, DEPTH * n),
            f"launch counts K1 {k1} K2f {k2f} K2b {k2b} over {n} steps")
    return dict(k1=k1, k2f=k2f, k2b=k2b)


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
        params = list(model.parameters())
        return (loss.item(), [state.optimizer.state[p]["momentum_buffer"] for p in params],
                [p.detach() for p in params], (attn_fast.launches, attn_fast.bwd_launches))

    k32 = one_step(torch.float32, False, None)
    p32 = one_step(torch.float32, False, attn_fast.mha_forward_reference)
    b16 = one_step(torch.bfloat16, True, None)
    require(k32[3] == (DEPTH, DEPTH) and p32[3] == (0, 0) and b16[3] == (DEPTH, DEPTH),
            f"parity launches {k32[3]} {p32[3]} {b16[3]}")

    def compare(got, want, what, loss_tol, tol):
        e_loss = abs(got[0] - want[0]) / abs(want[0])
        e_grad = max(norm_err(a, b) for a, b in zip(got[1], want[1]) if b.abs().max() > 0)
        zero_same = all((a == 0).all().item() for a, b in zip(got[1], want[1])
                        if b.abs().max() == 0)
        e_param = max(norm_err(a, b) for a, b in zip(got[2], want[2]))
        print(f"step parity, {what} (AST-Base, batch {PARITY_BATCH}, one SGD step): loss "
              f"{got[0]:.6f} vs {want[0]:.6f}, rel {e_loss:.3e} (<= {loss_tol}); gradients "
              f"{e_grad:.3e}, parameters after the update {e_param:.3e}, normalised per "
              f"parameter (<= {tol})", flush=True)
        require(e_loss <= loss_tol and e_grad <= tol and zero_same and e_param <= tol,
                f"step parity {what}")

    compare(k32, p32, "f32 kernels vs f32 plain attention", STEP_F32_LOSS, STEP_F32_GRAD)
    compare(b16, p32, "bf16 kernels (remat attn_res) vs f32 plain attention", STEP_BF16_LOSS,
            STEP_BF16_GRAD)


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
    names = ("mel_power", "attn_fwd", "attn_bwd")
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

    # launches: the training slice's run; launches_serving: the serving slice's
    kernels = [
        dict(name="mel_power", route="cuda", source="dlsc_tpu_torch/csrc/mel_power.cu",
             replaces="dlsc_tpu/ops/mel_pallas.py:77", launches=train["k1"],
             launches_serving=serve["k1"], **k1),
        dict(name="attn_fwd", route="cuda", source="dlsc_tpu_torch/csrc/attn_fwd.cu",
             replaces="dlsc_tpu/ops/attn_fast.py:125", launches=train["k2f"],
             launches_serving=serve["k2"], **k2f),
        dict(name="attn_bwd", route="cuda", source="dlsc_tpu_torch/csrc/attn_bwd.cu",
             replaces="dlsc_tpu/ops/attn_fast.py:205", launches=train["k2b"],
             launches_serving=serve["k2b"], **k2b),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
