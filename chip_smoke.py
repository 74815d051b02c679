#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dlsc_tpu_torch) of the AST serving path on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own lines; any failure raises (exit code != 0):

0. start-up: require CUDA, print the card's name and power limit, turn TF32
   off for matmuls and cuDNN, build the two kernels from csrc/;
1. kernel K1 (mel power) against its plain version, both mel configs;
2. kernel K2 (attention forward) against its plain version, f32 and bf16;
3. the slice: AST-Base (bf16, seeded random weights) exported, loaded on the
   card and served over HTTP to a burst of concurrent requests; the launch
   counters must show that every device batch went through both kernels;
   one batch is then held against the same weights run with plain ops in
   f32, and serving latency and throughput are timed.

The last two lines are a JSON object with each kernel's launches, error and
times, and ``{"ok": true, "device": {...}}``. Needs no network and one card.
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

from dlsc_tpu_torch import _kernels
from dlsc_tpu_torch.data import wav as W
from dlsc_tpu_torch.data.pipeline import DevicePipeline, PipelineConfig
from dlsc_tpu_torch.models.ast import ASTModel
from dlsc_tpu_torch.ops import attn_fast, mel_kernel
from dlsc_tpu_torch.ops import mel as M
from dlsc_tpu_torch.server import ModelServer
from dlsc_tpu_torch.serving import export_model, make_infer

# configs/model/ast.yaml, written out: the card's machine may lack pyyaml.
AST_BASE = dict(num_classes=50, sample_rate=44_100, patch_size=16, patch_stride=10,
                overlap=6, pretrained_model="deit_base_patch16_384")
CLIP = 220_500          # 5 s at 44.1 kHz
DEPTH = 12
SERVE_BATCH = 8
BURST = 16              # concurrent /predict_raw requests, plus one /predict
LATENCY_SAMPLES = 100   # batch-1 calls timed: p90 has 10 samples beyond it

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
            result = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)
    return result


def phase_attn(dev: torch.device, gen: torch.Generator) -> dict:
    B, H, N, dh, n_real = SERVE_BATCH, 12, 1664, 64, 1645   # AST-Base, 5-s clips
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
    return dict(max_abs_err=e_out, ms=ms, plain_ms=plain)


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
    k1, k2 = mel_kernel.launches, attn_fast.launches
    # --------------------------------------------------------------------------
    probs = [_check_probs(s, r, f"request {i}") for i, (s, r) in enumerate(answers)]
    print(f"served {len(answers)} requests ({BURST} /predict_raw + 1 /predict) in "
          f"{t_burst:.3f} s after {t_load:.3f} s of load + warm-up; {batches} device "
          f"batches of {SERVE_BATCH}; launches K1 {k1} K2 {k2}", flush=True)
    require(batches >= 1 + -(-len(bodies) // SERVE_BATCH), f"only {batches} device batches")
    require(k1 == batches and k2 == DEPTH * batches,
            f"launch counts K1 {k1} K2 {k2} for {batches} device batches")
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
    return dict(k1=k1, k2=k2)


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
    for name in ("mel_power", "attn_fwd"):
        _kernels.load(name)
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc: {', '.join(f'{k} {v:.2f} s' for k, v in _kernels.build_seconds.items())}) "
          f"torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)

    gen = torch.Generator().manual_seed(args.seed)
    k1 = phase_mel(dev, gen)
    k2 = phase_attn(dev, gen)
    with tempfile.TemporaryDirectory() as tmp:
        counts = phase_slice(dev, args.seed, Path(tmp), card)

    kernels = [
        dict(name="mel_power", route="cuda", source="dlsc_tpu_torch/csrc/mel_power.cu",
             replaces="dlsc_tpu/ops/mel_pallas.py:77", launches=counts["k1"], **k1),
        dict(name="attn_fwd", route="cuda", source="dlsc_tpu_torch/csrc/attn_fwd.cu",
             replaces="dlsc_tpu/ops/attn_fast.py:125", launches=counts["k2"], **k2),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
