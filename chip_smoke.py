#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dlsc_tpu_torch) of AST-Base, AST-MoE, AST-Small, AST-Mini, EnvNet-v2, the spectrogram CNN and LEAF serving and training, its training entry point, AST's remat policies, the timm/DeiT weight import, int8 serving, AST-MoE's capacity dispatches and expert-choice router, the HPO layer and its vmapped multi-trial runner (its trials over ranks too), its multi-device layer (MoE blocks under tensor parallelism too) and its counter-based dropout draw, on the visible GPUs (one by default).

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own lines; any failure raises (exit code != 0):

0. start-up: require CUDA, print the card's name and power limit, turn TF32
   off for matmuls and cuDNN, build the six kernel sources from csrc/ (one
   nvcc each, all at once);
1. kernel K1 (mel power, an FFT in shared memory): registers and no spill
   (``-Xptxas -v``, printed); against its plain version, both mel configs
   (AST 1024/160/400, CNN 1024/512/1024) at the serving batch 8 and at the
   training batch 64, each also by graph replay with its share of the
   bound, two calls of each bit-identical;
2. kernel K2f (attention forward): its bf16 kernel's own SASS must hold
   HGMMA (wgmma) and no HMMA, and it spills nothing (``-Xptxas -v``,
   printed with its registers); against its plain version, f32 and bf16 at
   batch 8, bf16 also by graph replay beside ``F.scaled_dot_product_attention``
   with the same key mask, with its TFLOP/s and share of the bound, two bf16
   calls bit-identical; then bf16 at the training batch 64;
3. kernel K2b (attention backward): its SASS must hold HGMMA (wgmma) and no
   HMMA, its bf16 kernels spill nothing (``-Xptxas -v``, printed); against
   its plain version at AST-Base shapes, f32 and bf16 at batch 8, bf16 also
   by graph replay beside the SDPA backward and the bound, two bf16 calls
   bit-identical; then bf16 at the training batch 64 of AST-Base and of
   AST-Mini (3 heads), one batch row of the plain version at a time;
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
   n_real 689, bf16, against their plain versions one batch row at a time,
   both also by graph replay and two calls of each bit-identical;
8. kernels K4a (gmm) and K4b (tgmm): their bf16 wgmma kernels (K4a in both
   rhs layouts) must hold HGMMA and no HMMA in their own SASS and spill
   nothing; against their plain versions at AST-MoE's batch-64 shapes
   (88 192 sorted rows): the two expert products, their transposed-rhs dlhs
   and both tgmm, bf16 with the group sizes of a real router draw and with
   a skewed set, each also by graph replay (K4b: both of its kernels) beside
   ``torch._grouped_mm``'s, with its share of the bound, and two calls
   bit-identical, f32 at one shape; then each product at F/2 (a
   tensor-parallel rank's, phase 31) by graph replay beside
   ``torch._grouped_mm``;
9. AST-MoE serving: exported with seeded weights, loaded on the card, one
   batch of 8 clips (per device batch K1 1, K2f 12, gmm 24, K2b and tgmm
   0), held against the same weights in f32 with plain attention and plain
   grouped matmul on the same routes, and timed at batch 8 and 64;
10. AST-MoE training: ``scripts/bench.py --model ast_moe``'s configuration,
    2 warm-up and 10 timed steps at batch 64 (per step K1 1, K2f 12, K2b 12,
    gmm 72, tgmm 24), with the tokens routed to each (block, expert) whose
    output reaches the loss counted through the MoE layers' ``route_hook``
    (``ExpertTokens``; in the last block only the CLS token's): every
    parameter changed, and every expert that got such a token; the experts
    that got none are printed and counted; then the bench's profiled record;
10b. the dropout draw (``csrc/dropout_draw.cu``, Philox4x32-10; no TPU
    kernel): registers and no spill; bit-equal to its plain version at
    AST-Base's MLP sites and AST-MoE's experts' (sorted rows) and output
    sites at batch 64 in bf16, in f32, in its keep-mask mode, at a rank's
    rows and units of the unsplit draw, and under its vmap rule (4 trials
    in one launch); each site timed beside the plain version, the
    ``torch.rand`` draw it replaced and ``F.dropout``. Every phase counts
    the draw's launches (one a site, forward, re-forward and backward);
11. AST-MoE card parity of one train step at batch 4, dropout 0.1 with one
    seed: f32 kernels vs f32 plain ops, and bf16 kernels (remat
    ``attn_res``) vs bf16 plain ops that round where the TPU kernels round
    (``_RoundedPlainMha``), each pair on the same routes; there a router
    weight's gradient error is divided by the size of its sum's terms,
    c max(|G|^T |X|) (``RouterTerms``), every other parameter's by its
    max |ref|; the bf16 runs against f32 plain ops are printed, not bounds
    (``--moe-parity-seeds A-B`` runs this phase alone over seeds, and
    ``--moe-parity-fault NAME`` with it plants a fault in the bf16 kernels'
    run: ``MOE_PARITY_FAULTS``);
12. kernels K3f and K3b (fused residual add + LayerNorm): registers and no
    spill in any K3 kernel (``-Xptxas -v``, printed); against their plain
    versions at the three widths of the models' training batch 64 (AST-Small
    49 152 x 384, AST-Base 106 496 x 768, AST-Mini 106 496 x 192) in bf16,
    and in f32 at AST-Small's, two K3b calls bit-identical at each, beside
    the unfused site they replace (the add, then LayerNorm in f32, and its
    autograd backward) and PyTorch's own LayerNorm forward and backward on
    the stored r (``aten.native_layer_norm``, ``_backward``), with K3b's two
    kernels timed apart (profiler);
13. kernels K2f and K2b at the shapes that only the JAX package's library
    attention kernels K5 (generic splash) and K6 (flash) reached, now
    served by K2: the longest sequence the models admit (AST-Base on a 10-s
    clip, (8, 12, 3328, 64), n_real 3301) in bf16 and f32, and n_real == N
    at (8, 6, 768, 64) (no key masked), beside SDPA; K2f's and K2b's
    reruns bit-identical;
14. AST-Small serving: exported by ``scripts/export.py model=ast_small
    +model.ln_fused=true +model.attn_impl=flash``, loaded on the card, one
    batch of 8 (per device batch K1 1, K2f 12, K3f 12, no backward
    kernel), held against the same weights in f32 with plain attention and
    the plain add + LN, and timed at batch 8 and 64;
15. AST-Small training: ``scripts/bench.py --model ast_small --ln-fused``,
    2 warm-up and 10 timed steps at batch 64 (per step K1 1, K2f 12, K2b 12,
    K3f 24 with the remat re-forward, K3b 12), every parameter changed, the
    bench's profiled record; then one AST-Base ``--ln-fused`` run of as many
    steps, timed beside phase 5's;
16. AST-Small card parity of one train step with ``ln_fused`` at batch 4,
    dropout 0.1 with one seed: f32 through K2 and K3 vs f32 plain ops, and
    bf16 through the kernels (remat ``attn_res``) vs the f32 plain step;
17. AST-Mini with ``ln_fused``: one served batch of 8 (K2 at 3 heads, K3 at
    width 192) held against plain f32 ops, then 2 train steps at batch 64
    with every parameter changed;
18. the trainer slice (``phase_trainer``), AST-Base at full width and depth
    through the port's CLIs: synthetic shards in ESC-50's layout (5 folds,
    50 classes, 4 clips a class a fold, 5 s, PCM16, seeded); ``scripts/
    train.py model=ast`` in bf16 at batch 64 for 2 epochs of 11 steps from
    the device-resident pool (K1 = steps + eval batches, K2f 12x that, K2b
    12 x steps), every epoch's loss finite, a best and a ``last``
    checkpoint, test metrics in [0, 1]; the test fold from the pool and from
    host batches (equal confusion matrices, losses within 1e-5);
    ``scripts/evaluate.py`` on the best checkpoint (the train run's test);
    ``predict`` by checkpoint and by an exported artifact on a 5-s, a 12-s
    and a 2-s file (the same top-1, probabilities within 1e-2); an
    ``auto_resume`` run that continues from step 22 for one epoch. Prints the
    trainer's epoch clips/s beside phase 5's bench clips/s, the fit's wall
    time, checkpoint writes and the data's generation time;
19. EnvNet-v2, the CNN and LEAF (n_filters 128) at full width on 5-s clips,
    seeded weights and randomised BatchNorm statistics: the card's eval
    forward in f32 with TF32 off against the CPU's f32 forward on the same
    inputs (normalised 1e-4), the error with cuDNN's TF32 on printed;
20. their train steps at batch 64 through ``scripts/bench.py``'s functions
    (f32, EnvNet-v2 with BC mixing and KLDiv), cuDNN at PyTorch's default
    (TF32 on), 2 warm-up and 10 timed steps and two profiled: every loss
    finite, every parameter and BatchNorm statistic changed, K1 once a CNN
    step; the bench's record each;
21. one f32 step of each (TF32 off, the same draws, dropout off) on the
    card against the same step on the CPU: loss, gradients, parameters and
    BatchNorm statistics within 1e-4;
22. each family exported by ``scripts/export.py`` and serving a batch of 8
    (K1 once for the CNN), EnvNet-v2 with ten test crops over HTTP, then
    every row of ``scripts/bench_infer.py`` (the AST family's, these and the
    10 int8 rows; the batch-1 rows at 100 calls, not the bench's 1000, the
    others at 10, not 20), each
    row's device time (graph replay) at most its median
    latency; each int8 row's sigmoid outputs against the bf16 row of its
    model and batch from the same float weights (0.05 w8a8, 0.06 w8);
23. EnvNet-v2 through the train CLI on phase 18's shards (2 epochs, f32,
    batch 64, BC mixing + KLDiv, ten crops for val and test, SWA from epoch
    1 with the BatchNorm refresh, the best checkpoint only) and
    ``evaluate`` on its best checkpoint (the test's confusion matrix);
24. AST-Base (768/12/12) under the remat policies ``full``, ``dots``,
    ``attn_out``, ``attn_res``, ``attn_res_qkv`` and ``attn_res_fc1``: an
    f32 forward and backward at batch 4 through the kernels, gradients
    within 1e-5 of ``full``'s, K2f 24 or 12 and K2b 12; the bench's bf16
    batch-64 step under each (ms, clips/s, peak GiB, launches a step); then
    AST-MoE at batch 64 under ``attn_res_moe`` against ``attn_res`` on the
    same routes: gradients within 1e-5, gmm 48 against 72 launches;
25. a seeded ``deit_base_patch16_384`` state dict → ``import_vit`` (audit on
    the card, then the weights) → ``export model=ast`` in bf16, ``+quant=w8``
    and ``+quant=w8a8`` → each served on the card (K1 1, K2f 12 a batch)
    against the reference recipe's forward in plain f32 ops (3e-2 bf16, 0.06
    w8, 0.05 w8a8); the w8a8 artifact over HTTP; ``torch._int_mm`` at fc1's
    shape beside the bf16 GEMM;
26. AST-MoE training (``scripts/bench.py --model ast_moe``'s configuration,
    full width and depth, bf16, batch 64: 689 → 768 tokens in groups of
    256, capacity 80) on the capacity paths ``--router token --dispatch
    einsum``, ``--dispatch scatter`` and ``--router expert``, 2 warm-up and
    10 timed steps each (per step K1 1, K2f 12, K2b 12, no gmm or tgmm):
    ms, clips/s, peak GiB, busy share, ``moe/drop_frac`` and ``moe/util``
    beside phase 10's ragged row; every parameter changed, and every expert
    that kept a token whose output reaches the loss (``ExpertTokens``);
    then at batch 4, dropout 0.1 with one seed: each path's f32 step
    through the kernels against plain ops on the same routes (1e-4), the
    einsum and scatter paths' plain f32 steps on the same routes against
    each other (1e-5), and the scatter path's bf16 step at batch 64 run
    twice, its loss and gradients bit-identical;
27. the HPO slice: ``scripts/optimize_hyperparams.py model=ast_moe`` on
    phase 18's shards, bf16, 2 epochs a trial, 4 trials of the configs'
    AST-MoE search space (batch 64–256, 4/8/16 experts, both routers) with
    the configs' TPE seed, on a SQLite study: each trial's params, state,
    value, fit seconds, peak GiB and launches (K1 = steps + eval batches,
    K2f 12x that, K2b 12 x steps; gmm and tgmm in the token-choice trials
    only); no trial failed, both routers ran, the best config written; then
    ``scripts/analyze_study.py`` on the db (summary JSON, HTML reports,
    CSV) and ``scripts/debug_optimize.py optuna.n_trials=1``;
28. the vmapped HPO slice: ``optimize_hyperparams model=ast
    +model.ln_fused=true +optuna.vmapped.enabled=true`` on phase 18's shards
    (AST-Base at full width and depth, bf16, K 4 slots recycled over 6
    trials of 2 epochs at batch 16, searching lr, weight decay, dropout,
    mixup α, T_max and warmup): every trial COMPLETE or PRUNED with its own
    lr, the db reloaded, the launches exact (per lockstep step K1 1, K2f 12,
    K2b 12, K3f and K3b 12 x K; per eval batch K1 1, K2f 12, K3f 12 x K);
    one vmapped step timed (AST-Base at K 4 with per-trial dropout,
    AST-Small at K 8, batch 16 a trial: ms, clips/s, peak GiB, busy share,
    launches) beside K single-trial steps of the bench's; K2f and K2b
    folded over the trials against one launch a trial (equal); one f32
    vmapped step at K 2 (AST-Base widths, depth 2, draws replayed) against
    each trial's step in plain ops on the CPU: loss, the clipped gradient
    and its square (Adam's moments) and the parameter change where the
    gradient sets it, 1e-4; the AST-Base step timed again without dropout
    (per-trial dropout's cost); the study passes ``optuna.vmapped.mesh``,
    which on one card runs in one process;
29. the multi-device layer (``dlsc_tpu_torch/parallel``) at W = the
    visible cards over NCCL, the ranks started by ``parallel.mesh.spawn``:
    DDP, FSDP, TP (degree W), PP (W stages, 2 microbatches) on AST-Base
    (bf16, ``ln_fused``), the ragged AST-MoE under DDP and AST-MoE with its
    experts over W ranks, global batch 16, 2 steps each: step 1's loss and
    gathered gradients against the one-process step of the same model on
    the same card and batch (``MULTI_GRAD``), the launches per rank per
    step, step time and peak memory; then ``scripts/train.py
    trainer.devices=auto +trainer.fsdp=true`` fits 2 steps on phase 18's
    shards, and ``export`` and the server answer one request from its
    checkpoint;
30. two DDP ranks on the one card over gloo (CUDA tensors; NCCL refuses two
    ranks on one device): AST-Base bf16 with SpecAugment and Mixup, batch
    16 = 2 x 8, against the one-process step; each rank launches K1 once,
    K2f and K2b 12 times a step. It measures no interconnect;
31. two ranks on the one card over gloo: AST-MoE (full width and depth,
    ragged, dropout 0.1) under tensor parallelism 2 (each rank half of
    every expert's hidden units: K4a and K4b at F/2), 2 steps at batch 16
    in f32 and in bf16 against the one-process step on the same routes
    (f32 1e-4, bf16 5e-2: the partial outputs are rounded to bf16 before
    the sum), the launches per rank per step; then a vmapped AST-Base study
    (bf16, ``ln_fused``, K 4 = 2 a rank, per-trial dropout and mixup α, 3
    steps at batch 8 a trial) through ``VmappedTrialRunner(plan=...)``
    against the same study in one process: the trials equal, each trial's
    accuracies within one validation sample, its parameters within 1e-3 of
    their largest, the launches exact. It measures no interconnect.

``python3 chip_smoke.py --multi-device`` runs phases 29, 30 and 31 alone
(after the build, with its own copy of phase 18's shards).

Routes: a near-tie between two router gates flips a token's expert under a
perturbation as small as bf16 rounding, and a flipped route moves a whole
expert output. The MoE checks therefore record the run under test's top-k
choices and replay them in the plain run (``RouteLog``), so that they hold
the kernels to their plain versions; they also print how many routes a
free run would flip, and what that does to the outputs.

The last two lines are a JSON object with each kernel's launches, error,
times and bound, and ``{"ok": true, "device": {...}}``. Needs no network
and one card; ``model=ast_small``'s export and phase 18 go through the
CLIs, so pyyaml.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import http.client
import itertools
import json
import os
import re
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
from dlsc_tpu_torch.models.ast_mini import ASTMiniViT
from dlsc_tpu_torch.models.ast_moe import ASTMoE
from dlsc_tpu_torch.models import cnn_esc50, leaf
from dlsc_tpu_torch.models.ast_small import ASTViTSmall
from dlsc_tpu_torch.models.layers import BatchNorm
from dlsc_tpu_torch.models.moe import MOE_METRICS, as_moe_spec
from dlsc_tpu_torch.models.moe import capacity as moe_capacity
from dlsc_tpu_torch.models.vit import ASTViT
from dlsc_tpu_torch.ops import attn_fast, dropout_draw, mel_kernel
from dlsc_tpu_torch.ops import gmm as gmm_ops
from dlsc_tpu_torch.ops import ln_fused
from dlsc_tpu_torch.ops import mel as M
from dlsc_tpu_torch.scripts import bench, bench_infer
from dlsc_tpu_torch.server import ModelServer
from dlsc_tpu_torch.serving import export_model, load_exported, make_infer
from dlsc_tpu_torch.train.losses import CrossEntropyLoss, KLDivLoss
from dlsc_tpu_torch.train.metrics import MetricState
from dlsc_tpu_torch.train.optim import sgd
from dlsc_tpu_torch.train.state import TrainState
from dlsc_tpu_torch.train.steps import make_train_step
from dlsc_tpu_torch.utils.mfu import peak_tflops

AST_BASE = bench.AST_BASE   # configs/model/ast.yaml, written out
CLIP = bench.CLIP           # 5 s at 44.1 kHz
DEPTH = 12
HEADS = 12
AST_BASE_WIDTH = 768
N_PAD, N_REAL = 1664, 1645  # AST-Base tokens at 5 s, padded to the 128 grain
SERVE_BATCH = 8
BURST = 16              # concurrent /predict_raw requests, plus one /predict
LATENCY_SAMPLES = 100   # batch-1 calls timed: p90 has 10 samples beyond it
SERVING_ROW_CALLS = 10  # phase 22's batched bench_infer rows (the bench's own: 20), which
                        # keeps the script near 1000 s of its 1200-s limit
TRAIN_BATCH, WARMUP_STEPS, TIMED_STEPS = 64, 2, 10
PARITY_BATCH = 4
AST_MOE = bench.AST_MOE  # configs/model/ast_moe.yaml, written out
MOE_HEADS, MOE_DIM, MOE_FF = 6, 384, 1536
MOE_N_PAD, MOE_N_REAL = 768, 689  # AST-MoE tokens at 5 s (8 x 86 patches + CLS)
MOE_ROWS = TRAIN_BATCH * MOE_N_REAL * AST_MOE["top_k"]   # 88 192 sorted rows at batch 64
# one expert with more than half the rows, an empty one, no multiple of 128
SKEWED_SIZES = (45_001, 0, 12_345, 9_999, 7_777, 6_543, 4_321, 2_206)
AST_SMALL = bench.AST_SMALL   # configs/model/ast_small.yaml, written out
AST_MINI = bench.AST_MINI     # configs/model/ast_mini.yaml, written out
MINI_DEPTH, MINI_HEADS = 6, 3   # ASTMiniViT's 192 wide, 6 blocks, 3 heads
MINI_N_PAD = N_PAD            # AST-Mini has AST-Base's patch grid: 1645 tokens, 1664
# K3 at the training batch 64: (name, rows, width)
LN_SHAPES = (("AST-Small", TRAIN_BATCH * MOE_N_PAD, 384),
             ("AST-Base", TRAIN_BATCH * N_PAD, 768),
             ("AST-Mini", TRAIN_BATCH * MINI_N_PAD, 192))
LN_FWD_OPS, LN_BWD_OPS = 8, 12   # f32 operations per element (see phase_ln)
LONG_N_PAD, LONG_N_REAL = 3328, 3301   # AST-Base on a 10-s clip: 12 x 275 patches + CLS
CNN_MEL = PipelineConfig().cnn_mel_config()   # the CNN's front end: 1024/512/1024

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
STEP_BF16_LOSS = 1e-2   # bf16 step through the kernels vs a plain step: 12 blocks
STEP_BF16_GRAD = 5e-2   # of bf16 activations (2^-8 relative per op) forward and
                        # back. AST-Base and AST-Small (phases 6, 16) are held to
                        # the f32 plain step. AST-MoE (phase 11) is held to a bf16
                        # plain step on the same routes that rounds where the TPU
                        # kernels round (P before P·V, the grouped products'
                        # outputs): there the bound covers the kernels' own
                        # rounding and summation order, not the bf16 model's
                        # noise against f32, which a router-weight gradient
                        # amplifies to the bound's size (PERF.md §6)
GMM_F32_ERR = 1e-5      # K4 f32, normalised by max |out|: summation order only
GMM_BF16_ERR = 1e-2     # K4 bf16: the output rounded to bf16 (2^-9 relative),
                        # f32 sums on both sides
LN_F32_ERR = 1e-5       # K3 f32, normalised by the max |value|: summation order
LN_BF16_ERR = 1e-2      # K3 bf16: y and dx stored in bf16 (2^-9 relative), the
                        # same f32 arithmetic on both sides; r exact in both


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


def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in one
    CUDA graph, its replays timed by CUDA events. A replay launches the
    kernels without the Python around them, so a call whose kernels are
    shorter than its Python (where CUDA events around each call time the
    host) is timed by its kernels. ``torch.profiler``'s kernel records were
    tried for this and dropped kernels in windows this short."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the capturing stream, as capture asks
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = float(np.median(cuda_times(graph.replay, iters=5, warmup=1))) / reps
    del graph
    return ms


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


def router_err(got: torch.Tensor, want: torch.Tensor, scale: float) -> float:
    """max |got - want| / scale, in f32: a router weight's gradient error in
    units of the size of its sum's terms (``RouterTerms.scale``)."""
    return ((got.float() - want.float()).abs().max() / scale).item()


def _reset_launches() -> None:
    mel_kernel.reset_launches()
    attn_fast.reset_launches()
    gmm_ops.reset_launches()
    ln_fused.reset_launches()
    dropout_draw.reset_launches()


def _launch_counts() -> dict:
    """Every kernel's launches since the last ``_reset_launches``."""
    return dict(k1=mel_kernel.launches, k2f=attn_fast.launches, k2b=attn_fast.bwd_launches,
                gmm=gmm_ops.launches, tgmm=gmm_ops.tgmm_launches, k3f=ln_fused.launches,
                k3b=ln_fused.bwd_launches, drop=dropout_draw.launches)


def _counts(k1=0, k2f=0, k2b=0, gmm=0, tgmm=0, k3f=0, k3b=0, drop=0) -> dict:
    """The launch counts a path must show, every kernel named. ``drop``: the
    dropout draw's, one launch a site (a ViT block has 2 in its MLP or MoE)
    in each forward, re-forward (remat) and backward (``_draws``)."""
    return dict(k1=k1, k2f=k2f, k2b=k2b, gmm=gmm, tgmm=tgmm, k3f=k3f, k3b=k3b, drop=drop)


def _draws(blocks: int, remat: bool) -> int:
    """The dropout draw's launches in one train step of ``blocks`` ViT
    blocks with MLP (or expert) dropout: 2 sites, each drawn in the forward,
    the backward and, under remat, the re-forward."""
    return 2 * blocks * (3 if remat else 2)


# the dropout draw's launches in one train step of the CNN families: one site
# a dropout layer (EnvNet-v2's two FC layers, the CNN's one, LEAF's three MLP
# layers), each drawn in the forward and the backward
FAMILY_DRAWS = {"envnet_v2": 4, "cnn_esc50": 2, "leaf": 6}


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


def _mel_bound(cfg: M.MelConfig, batch: int, n_out: int) -> dict:
    """K1's bound: what the function needs at the least, not the work the
    kernel runs: per frame the window, a real FFT (~2.5 n log2 n), the power
    (3 per bin) and the filterbank's nonzero entries (2 each); bytes: the
    wave, those entries and the output, each once."""
    nnz = int(np.count_nonzero(M.mel_filterbank_np(cfg)))
    per_frame = (cfg.win_length + 2.5 * cfg.n_fft * np.log2(cfg.n_fft)
                 + 3 * (cfg.n_fft // 2 + 1) + 2 * nnz)
    flops = batch * cfg.num_frames(CLIP) * per_frame
    return bound(flops, F32_FLOPS, 4 * (batch * CLIP + nnz + n_out))


def _mel_case(wave: torch.Tensor, cfg: M.MelConfig) -> dict:
    """K1 on ``wave`` against its plain version: errors (normalised, max
    abs, dB, AST features), CUDA-event times in turns with the plain
    version, the graph-replay time with its share of the bound, and two
    calls bit-identical; printed, and required within the bars."""
    got, ref = mel_kernel.mel_power(wave, cfg), M.mel_spectrogram(wave, cfg)
    require(got.shape == ref.shape, f"K1 shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    norm, abs_err = norm_err(got, ref), (got - ref).abs().max().item()
    got_db, ref_db = M.amplitude_to_db(got, cfg.top_db), M.amplitude_to_db(ref, cfg.top_db)
    db = (got_db - ref_db).abs().max().item()
    ast = (M.ast_normalize(got_db) - M.ast_normalize(ref_db)).abs().max().item()
    ms, plain_ms = paired_ms(lambda: mel_kernel.mel_power(wave, cfg),
                             lambda: M.mel_spectrogram(wave, cfg))
    g_ms = graph_ms(lambda: mel_kernel.mel_power(wave, cfg), reps=5)
    det = _reruns_equal(lambda: mel_kernel.mel_power(wave, cfg))
    bd = _mel_bound(cfg, wave.shape[0], got.numel())
    print(f"K1 mel_power hop {cfg.hop_length} win {cfg.win_length}: B {wave.shape[0]} x "
          f"{wave.shape[1]} -> {tuple(got.shape)}  norm_err {norm:.3e} (< {MEL_NORM_ERR})  "
          f"max_abs {abs_err:.3e}  dB {db:.3e} (< {DB_ABS_ERR})  ast {ast:.3e} (< "
          f"{AST_ABS_ERR})  median kernel {ms:.3f} ms, {g_ms:.4f} by graph replay "
          f"({bd['bound_ms'] / g_ms:.3f} of the bound {bd['bound_ms']:.4f} ms, "
          f"{bd['bound_by']})  plain {plain_ms:.3f} ms; two calls bit-identical: {det}",
          flush=True)
    require(norm < MEL_NORM_ERR and db < DB_ABS_ERR and ast < AST_ABS_ERR and det,
            f"K1 disagrees with its plain version at batch {wave.shape[0]}, hop "
            f"{cfg.hop_length}")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, graph_ms=g_ms,
                bound_share=bd["bound_ms"] / g_ms, deterministic=det, **bd)


def phase_mel(dev: torch.device, gen: torch.Generator) -> dict:
    """K1: what it compiled to (``_build_report``: registers, no spill);
    against its plain version (``_mel_case``) for both mel configs at the
    serving batch 8 and at the training batch 64."""
    build = _build_report("mel_power")
    wave = (torch.randn(SERVE_BATCH, CLIP, generator=gen) * 0.3).to(dev)
    ast = _mel_case(wave, M.MelConfig())   # the slice's config
    cnn = _mel_case(wave, CNN_MEL)
    # the training slice's shape: the whole batch of 64 clips in one launch
    wave = (torch.randn(TRAIN_BATCH, CLIP, generator=gen) * 0.3).to(dev)
    train = _mel_case(wave, M.MelConfig())
    # the CNN's train batch (phase 20): 1024/512/1024, 431 frames
    cnn64 = _mel_case(wave, CNN_MEL)
    cases = (ast, cnn, train, cnn64)
    keys = ("ms", "plain_ms", "graph_ms", "bound_ms", "bound_share")
    # no single PyTorch call computes a mel power spectrogram
    return dict(ast, library_ms=None,
                max_abs_err=max(c["max_abs_err"] for c in cases),
                deterministic=all(c["deterministic"] for c in cases),
                **{f"{k}_batch64": train[k] for k in keys},
                **{f"{k}_cnn_batch64": cnn64[k] for k in keys}, **build)


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


def _reruns_equal(fn) -> bool:
    """Two calls of ``fn`` give the same bits in every output."""
    first, second = fn(), fn()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    return all(torch.equal(a, b) for a, b in zip(first, second))


def phase_attn(dev: torch.device, gen: torch.Generator) -> dict:
    """K2f at AST-Base shapes: what it compiled to (``_build_report``); f32
    and bf16 at batch 8 against the plain version, bf16 also by graph replay
    beside SDPA's, with its rate and share of the bound, two bf16 calls
    required bit-identical; then bf16 at the training batch 64, held against
    the plain version one batch row at a time."""
    build = _build_report("attn_fwd")
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
    finite = torch.isfinite(out).all().item() and torch.isfinite(lse).all().item()
    ms, plain = paired_ms(lambda: attn_fast.fast_mha_forward(qb, kb, vb, n_real),
                          lambda: attn_fast.mha_forward_reference(qb, kb, vb, n_real))
    print(f"K2 attn_fwd bf16 (same shape, f32 plain version on the same bf16 inputs): "
          f"out {e_out:.3e} lse {e_lse:.3e} (<= {ATTN_BF16_ERR})  median kernel {ms:.3f} ms  "
          f"plain {plain:.3f} ms", flush=True)
    require(e_out <= ATTN_BF16_ERR and e_lse <= ATTN_BF16_ERR and finite, "K2 bf16 disagrees")

    # yardstick, never on the port's path: SDPA with the same boolean key mask;
    # the kernel and SDPA alone by graph replay, in turns
    mask = _key_mask(N, n_real, dev)

    def kernel():
        return attn_fast.fast_mha_forward(qb, kb, vb, n_real)

    def sdpa():
        return F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask, scale=1.0)

    lib = float(np.median(cuda_times(sdpa)))
    g0, lib_g0, lib_g1, g1 = (graph_ms(f) for f in (kernel, sdpa, sdpa, kernel))
    dev_ms, lib_dev_ms = (g0 + g1) / 2, (lib_g0 + lib_g1) / 2
    deterministic = _reruns_equal(kernel)
    flops = 4 * B * H * N * n_real * dh
    bd = bound(flops, BF16_TENSOR_FLOPS, _attn_bytes(B, H, N, dh, 4, 2))
    share, ratio = bd["bound_ms"] / dev_ms, dev_ms / lib_dev_ms
    print(f"K2 attn_fwd bf16: {dev_ms:.4f} ms by graph replay ({g0:.4f}, {g1:.4f}; {ms:.3f} by "
          f"CUDA events), {flops / dev_ms / 1e9:.1f} TFLOP/s over 4·B·H·N·n_real·dh, "
          f"{share:.3f} of the bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}); "
          f"F.scaled_dot_product_attention (boolean key mask) {lib_dev_ms:.4f} ms by graph replay "
          f"({lib:.3f} by CUDA events), kernel / SDPA {ratio:.3f}; two calls bit-identical: "
          f"{deterministic}", flush=True)
    require(deterministic, "two bf16 K2f calls on the same inputs differ")
    del qb, kb, vb, out, lse, ref, ref_lse

    # the training slice's shape: bf16 at batch 64 in one launch
    qt, kt, vt = _train_attn_inputs(dev, gen, 3)
    out, lse = attn_fast.fast_mha_forward(qt, kt, vt, n_real)
    ref, ref_lse = _per_batch(lambda q, k, v: attn_fast.mha_forward_reference(
        q.float(), k.float(), v.float(), n_real), qt, kt, vt)
    e_out64 = (out.float() - ref)[:, :, rows].abs().max().item()
    e_lse64 = (lse - ref_lse)[:, :, rows].abs().max().item()
    finite64 = torch.isfinite(out).all().item() and torch.isfinite(lse).all().item()
    del out, lse, ref, ref_lse
    ms64 = float(np.median(cuda_times(lambda: attn_fast.fast_mha_forward(qt, kt, vt, n_real))))
    det64 = _reruns_equal(lambda: attn_fast.fast_mha_forward(qt, kt, vt, n_real))
    print(f"K2 attn_fwd bf16 at the train batch (B {TRAIN_BATCH}): out {e_out64:.3e} lse "
          f"{e_lse64:.3e} (<= {ATTN_BF16_ERR})  median kernel {ms64:.3f} ms "
          f"({4 * TRAIN_BATCH * H * N * n_real * dh / ms64 / 1e9:.1f} TFLOP/s); two calls "
          f"bit-identical: {det64}", flush=True)
    require(e_out64 <= ATTN_BF16_ERR and e_lse64 <= ATTN_BF16_ERR and finite64 and det64,
            f"K2 bf16 disagrees at batch {TRAIN_BATCH}")
    return dict(max_abs_err=max(e_out, e_out64), ms=ms, plain_ms=plain, library_ms=lib, **bd,
                graph_ms=dev_ms, library_graph_ms=lib_dev_ms, bound_share=share,
                library_ratio=ratio, deterministic=deterministic and det64, ms_batch64=ms64,
                **build)


# each library's kernels (their names in the mangled symbols), and those that
# must run on wgmma
KERNEL_NAMES = {
    "attn_fwd": ("attn_fwd_bf16_kernel", "attn_fwd_f32_kernel"),
    "attn_bwd": ("attn_bwd_dq_bf16_kernel", "attn_bwd_dkv_bf16_kernel",
                 "attn_bwd_dq_f32_kernel", "attn_bwd_dkv_f32_kernel"),
    "gmm": ("gmm_bf16_wgmma_kernel", "tgmm_bf16_wgmma_kernel", "tgmm_reduce_kernel",
            "gmm_f32_kernel", "tgmm_f32_kernel"),
    "mel_power": ("mel_power_kernel",),
    "ln_fused": ("add_ln_fwd_kernel", "add_ln_bwd_kernel", "add_ln_bwd_reduce_kernel"),
    "dropout_draw": ("dropout_draw_kernel",),
}
WGMMA_KERNELS = {"attn_fwd": ("attn_fwd_bf16_kernel",),
                 "attn_bwd": ("attn_bwd_dq_bf16_kernel", "attn_bwd_dkv_bf16_kernel"),
                 "gmm": ("gmm_bf16_wgmma_kernel", "tgmm_bf16_wgmma_kernel"),
                 "mel_power": (), "ln_fused": (), "dropout_draw": ()}
_TEMPLATE_ARGS = {"13__nv_bfloat16": "bf16", "f": "f32"}


def _kernel_name(mangled: str, lib: str) -> str:
    """The kernel of ``lib`` that a mangled symbol names, with its template
    arguments where it has them: bool or int (``<0>``, ``<512>``) and the
    element type (``<bf16,3>``, ``<f32,3>``)."""
    for k in KERNEL_NAMES[lib]:
        i = mangled.find(f"{len(k)}{k}")
        if i >= 0:
            m = re.match(r"I((?:13__nv_bfloat16|f|L[bi]\d+E)+)E",
                         mangled[i + len(str(len(k))) + len(k):])
            if not m:
                return k
            args = re.findall(r"13__nv_bfloat16|L[bi]\d+E|f", m.group(1))
            return k + "<" + ",".join(_TEMPLATE_ARGS.get(a) or a[2:-1] for a in args) + ">"
    raise RuntimeError(f"chip_smoke: {mangled} is none of {KERNEL_NAMES[lib]}")


def _build_report(lib: str) -> dict:
    """What ``csrc/<lib>.cu`` compiled to, kernel by kernel: HGMMA (wgmma) and
    HMMA (mma.sync) instructions in its own SASS function (``cuobjdump
    -sass``), registers and spill-store bytes (``-Xptxas -v``, one of the
    library's build flags). The kernels of ``WGMMA_KERNELS`` must hold
    HGMMA and no HMMA and spill nothing; a library without wgmma kernels
    (K1's) must spill nothing at all."""
    sass = {_kernel_name(f, lib): text for f, text in _kernels.sass_functions(lib).items()}
    counts = {k: dict(hgmma=t.count("HGMMA"), hmma=len(re.findall(r"\bHMMA\b", t)))
              for k, t in sass.items()}
    regs, spills, kernel = {}, {}, None
    log = _kernels.build_log(lib)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            kernel = _kernel_name(m.group(1), lib)
        elif kernel and (m := re.search(r"(\d+) bytes spill stores", line)):
            spills[kernel] = int(m.group(1))
        elif kernel and (m := re.search(r"Used (\d+) registers", line)):
            regs[kernel] = int(m.group(1))
    serialized = [line.strip() for line in log.splitlines() if "serialized" in line]
    print(f"{lib} build: SASS {counts}; registers {regs}; spill store bytes {spills}"
          + (f"; ptxas: {serialized}" if serialized else ""), flush=True)
    wgmma = [k for k in counts if k.split("<")[0] in WGMMA_KERNELS[lib]]
    require(len(wgmma) >= len(WGMMA_KERNELS[lib]) and all(
        counts[k]["hgmma"] > 0 and counts[k]["hmma"] == 0 and spills.get(k) == 0
        for k in wgmma), f"{lib}: wgmma kernels {wgmma}: SASS {counts}, spills {spills}")
    require(WGMMA_KERNELS[lib] or (spills and not any(spills.values())),
            f"{lib}: spill store bytes {spills}")
    return dict(sass=counts, registers=regs, spill_store_bytes=spills)


def _split_ms(fn, kernels: dict, what: str) -> dict:
    """Device ms per call of each kernel of a wrapper, by name: ``kernels``
    maps a name to a pattern of its kernel's symbol; from
    ``torch.profiler``'s kernel records over 10 calls of ``fn``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        for name, pattern in kernels.items():
            if re.search(pattern, e.key):
                split[name] = e.device_time_total / e.count / 1e3
    require(set(split) == set(kernels), f"{what} profile: kernels {split}")
    return split


def _hold_bwd_per_batch(dev: torch.device, gen: torch.Generator, heads: int, n: int,
                        n_real: int, what: str) -> tuple[float, float]:
    """bf16 K2b at (TRAIN_BATCH, heads, n, 64) in one launch against its plain
    version one batch row at a time: (max abs error, CUDA-event ms)."""
    q, k, v, do = _train_attn_inputs(dev, gen, 4, heads, n)
    rows = slice(0, n_real)
    out, lse = attn_fast.fast_mha_forward(q, k, v, n_real)
    got = attn_fast.fast_mha_backward(q, k, v, out, lse, do, n_real)
    want = _per_batch(lambda *t: attn_fast.mha_backward_reference(*t, n_real),
                      q, k, v, out, lse, do)
    errs = [norm_err(g[:, :, rows], w[:, :, rows]) for g, w in zip(got, want)]
    abs_err = max((g - w)[:, :, rows].float().abs().max().item() for g, w in zip(got, want))
    zero_tails = all((g[:, :, n_real:] == 0).all().item() for g in got[1:])
    finite = all(torch.isfinite(g).all().item() for g in got)
    del got, want
    ms = float(np.median(cuda_times(
        lambda: attn_fast.fast_mha_backward(q, k, v, out, lse, do, n_real))))
    print(f"K2b attn_bwd bf16 at {what} (B {TRAIN_BATCH}, H {heads}, N {n}, n_real {n_real}): "
          f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} normalised (<= {BWD_BF16_ERR}), "
          f"max_abs {abs_err:.3e}, dK/dV rows >= n_real exactly 0: {zero_tails}  median kernel "
          f"{ms:.3f} ms", flush=True)
    require(max(errs) <= BWD_BF16_ERR and zero_tails and finite, f"K2b bf16 disagrees at {what}")
    return abs_err, ms


def phase_attn_bwd(dev: torch.device, gen: torch.Generator) -> dict:
    """K2b at AST-Base shapes from K2f's residuals: what it compiled to
    (``_build_report``); f32 and bf16 at batch 8, timed against the plain
    version, bf16 also by graph replay beside SDPA's backward and the bound,
    and two bf16 calls required bit-identical; then bf16 at the training
    batch 64 of AST-Base and of AST-Mini (3 heads), held against the plain
    version one batch row at a time."""
    build = _build_report("attn_bwd")
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
    # the kernels alone: 20 calls replayed from a CUDA graph (the wrapper's
    # Python, which CUDA events around one call include, is left out)
    dev_ms = graph_ms(lambda: attn_fast.fast_mha_backward(qd, kd, vd, out, lse, dod, n_real))
    split = _split_ms(lambda: attn_fast.fast_mha_backward(qd, kd, vd, out, lse, dod, n_real),
                      dict(dq=r"attn_bwd_dq_bf16_kernel", dkv=r"attn_bwd_dkv_bf16_kernel"), "K2b")
    first = attn_fast.fast_mha_backward(qd, kd, vd, out, lse, dod, n_real)
    second = attn_fast.fast_mha_backward(qd, kd, vd, out, lse, dod, n_real)
    deterministic = all(torch.equal(a, b) for a, b in zip(first, second))
    del first, second
    share, ratio = bd["bound_ms"] / dev_ms, dev_ms / lib_bwd
    # each kernel's rate over its own products: dQ 3 (S, dP, dQ), dK/dV 4
    rates = {k: n * 2 * B * H * N * n_real * dh / (split[k] * 1e-3) / BF16_TENSOR_FLOPS
             for k, n in (("dq", 3), ("dkv", 4))}
    print(f"K2b attn_bwd bf16: {dev_ms:.4f} ms by graph replay ({ms:.3f} by CUDA events), "
          f"{share:.3f} of the bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}, "
          f"10·B·H·N·n_real·dh), "
          f"{ratio:.3f}x SDPA's backward alone {lib_bwd:.3f} ms (SDPA forward + backward "
          f"{lib_fb:.3f} ms); two calls bit-identical: {deterministic}; profiler: dQ kernel "
          f"{split['dq']:.4f} ms ({rates['dq']:.3f} of the bf16 peak over its 3 products), dK/dV "
          f"kernel {split['dkv']:.4f} ms ({rates['dkv']:.3f} over its 4)", flush=True)
    require(deterministic, "two bf16 K2b calls on the same inputs differ")
    del q, k, v, do, qd, kd, vd, dod, out, lse, qr, kr, vr, o

    # the training slices' shapes: bf16 at batch 64 in one launch
    abs64, ms64 = _hold_bwd_per_batch(dev, gen, HEADS, N_PAD, N_REAL, "AST-Base's train batch")
    torch.cuda.empty_cache()
    abs_mini, ms_mini = _hold_bwd_per_batch(dev, gen, MINI_HEADS, MINI_N_PAD, N_REAL,
                                            "AST-Mini's train batch")
    return dict(max_abs_err=max(abs_err, abs64, abs_mini), ms=ms, plain_ms=plain,
                library_ms=lib_bwd, **bd, graph_ms=dev_ms, bound_share=share,
                library_ratio=ratio, deterministic=deterministic, kernel_ms=split, ms_batch64=ms64,
                ms_ast_mini_batch64=ms_mini, **build)


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
    require(counts == _counts(k1=batches, k2f=DEPTH * batches),
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


def phase_train(dev: torch.device, seed: int, card: str) -> tuple[dict, dict]:
    """The training slice at the bench's configuration, batch 64: (launch
    counts, the bench's record)."""
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
    require(counts == _counts(k1=n, k2f=DEPTH * n, k2b=DEPTH * n),
            f"launch counts {counts} over {n} steps")
    return counts, rec


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
    require(ln_fused.launches == ln_fused.bwd_launches == 0, "K3 ran without ln_fused")

    _compare_steps(k32, p32, "f32 kernels vs f32 plain attention (AST-Base", STEP_F32_LOSS,
                   STEP_F32_GRAD)
    _compare_steps(b16, p32, "bf16 kernels (remat attn_res) vs f32 plain attention (AST-Base",
                   STEP_BF16_LOSS, STEP_BF16_GRAD)


def _compare_steps(got, want, what: str, loss_tol: float, tol: float,
                   required: bool = True, readings: dict | None = None,
                   key: str = "", scales: dict | None = None,
                   batch: int = PARITY_BATCH, param_scales: dict | None = None,
                   scaled: str = "router weights, max |diff| / (c max(|G|^T |X|))"
                   ) -> tuple[float, float, float]:
    """Loss (relative), gradients (momentum buffers) and parameters after the
    update (normalised per parameter) of two one-step runs; a gradient that
    is exactly 0 on the reference side must be exactly 0 on the other. The
    gradients named in ``scales`` are divided by their scale instead of their
    max |ref| (``router_err``); their max-normalised reading is printed
    beside it, and bounds nothing. Raises past the bounds when ``required``;
    returns the three errors, and first puts them into ``readings`` when
    given (the gradients' under ``key``, the loss's and the parameters' under
    ``key`` + ``_loss``, ``_params``; with ``scales``, also the scaled names'
    readings both ways and every other parameter's under ``key`` +
    ``_router``, ``_router_max_normalised``, ``_other``). The parameters
    named in ``param_scales`` are divided by their scale, the others by their
    max |ref|; ``scaled`` labels the scaled names' line."""
    scales, param_scales = scales or {}, param_scales or {}

    def grad_err(a, b, name):
        return router_err(a, b, scales[name]) if name in scales else norm_err(a, b)

    e_loss = abs(got[0] - want[0]) / abs(want[0])
    grad_errs = sorted(((grad_err(a, b, name), name) for a, b, name in zip(got[1], want[1], got[4])
                        if b.abs().max() > 0), reverse=True)
    e_grad = grad_errs[0][0]
    zero_same = all((a == 0).all().item() for a, b in zip(got[1], want[1])
                    if b.abs().max() == 0)
    e_param = max(router_err(a, b, param_scales[name]) if name in param_scales
                  else norm_err(a, b) for a, b, name in zip(got[2], want[2], got[4]))
    worst = ", ".join(f"{name} {e:.2e}" for e, name in grad_errs[:3])
    note = '' if required else '  [not a bound: printed only]'
    print(f"step parity, {what}, batch {batch}, one SGD step): loss {got[0]:.6f} vs "
          f"{want[0]:.6f}, rel {e_loss:.3e} (<= {loss_tol}); gradients {e_grad:.3e} (largest: "
          f"{worst}), parameters after the update {e_param:.3e}, normalised per parameter (<= "
          f"{tol}); zero gradients the same: {zero_same}{note}", flush=True)
    if scales:
        named = dict(zip(got[4], zip(got[1], want[1])))
        router = max(e for e, name in grad_errs if name in scales)
        old = max(norm_err(*named[name]) for name in scales)
        other = max(e for e, name in grad_errs if name not in scales)
        print(f"  {scaled}: {router:.3e} (<= {tol}); the "
              f"same divided by max |ref|: {old:.3e}  [printed only]; every other parameter "
              f"(max-normalised): {other:.3e} (<= {tol}){note}", flush=True)
        if readings is not None:
            readings.update({f"{key}_router": router, f"{key}_router_max_normalised": old,
                             f"{key}_other": other})
    if readings is not None:
        readings.update({key: e_grad, f"{key}_loss": e_loss, f"{key}_params": e_param})
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
    fwd_graph_ms = graph_ms(lambda: attn_fast.fast_mha_forward(q, k, v, n_real), reps=5)
    fwd_det = _reruns_equal(lambda: attn_fast.fast_mha_forward(q, k, v, n_real))
    bwd_ms = float(np.median(cuda_times(
        lambda: attn_fast.fast_mha_backward(q, k, v, out, lse, do, n_real))))
    bwd_graph_ms = graph_ms(lambda: attn_fast.fast_mha_backward(q, k, v, out, lse, do, n_real),
                            reps=5)
    first = attn_fast.fast_mha_backward(q, k, v, out, lse, do, n_real)
    second = attn_fast.fast_mha_backward(q, k, v, out, lse, do, n_real)
    deterministic = all(torch.equal(a, b) for a, b in zip(first, second))
    del first, second
    print(f"K2 at AST-MoE's train shape (B {TRAIN_BATCH}, H {H}, N {N}, dh 64, n_real {n_real}) "
          f"bf16: attn_fwd out {e_out:.3e} lse {e_lse:.3e} (<= {ATTN_BF16_ERR}), median "
          f"{fwd_ms:.3f} ms ({fwd_graph_ms:.4f} by graph replay), two calls bit-identical: "
          f"{fwd_det}; attn_bwd dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
          f"normalised (<= {BWD_BF16_ERR}), max_abs {abs_err:.3e}, dK/dV rows >= n_real exactly "
          f"0: {zero_tails}, median {bwd_ms:.3f} ms ({bwd_graph_ms:.4f} by graph replay), two "
          f"calls bit-identical: {deterministic}", flush=True)
    require(e_out <= ATTN_BF16_ERR and e_lse <= ATTN_BF16_ERR and fwd_det,
            "K2f disagrees at AST-MoE's shape")
    require(max(errs) <= BWD_BF16_ERR and zero_tails and finite and deterministic,
            "K2b disagrees at AST-MoE's shape")
    return dict(fwd_ms=fwd_ms, fwd_graph_ms=fwd_graph_ms, fwd_err=max(e_out, e_lse),
                bwd_ms=bwd_ms,
                bwd_graph_ms=bwd_graph_ms, bwd_err=abs_err)


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


def _library_ms(fn) -> tuple[float | None, float | None, str]:
    """Median CUDA-event ms and graph-replay ms of a PyTorch yardstick call,
    or None and why it refused."""
    try:
        return float(np.median(cuda_times(fn))), graph_ms(fn), ""
    except (RuntimeError, TypeError, ValueError, AttributeError, NotImplementedError) as e:
        return None, None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def phase_gmm(dev: torch.device, gen: torch.Generator, seed: int) -> tuple[dict, dict]:
    """K4a and K4b against their plain versions at AST-MoE's batch-64 shapes:
    gmm1 x @ wi and gmm2 h @ wo (forward), their transposed-rhs dlhs, and
    tgmm for dwi and dwo; bf16 with a real router draw's group sizes and
    with a skewed set, f32 for gmm1 and tgmm1 on the router draw. What the
    library compiled to (``_build_report``); each bf16 product also by graph
    replay beside ``torch._grouped_mm``'s, and two calls required
    bit-identical."""
    build = _build_report("gmm")
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
            g_ms = graph_ms(kernel)
            lib_ms, lib_g_ms, why = _library_ms(lib)
            lib_err = None
            if lib_ms is not None:
                lib_err = norm_err(lib(), plain())
            det = _reruns_equal(kernel)
            key = "tgmm" if name.startswith("tgmm") else "gmm"
            max_abs[key] = max(max_abs[key], abs_err)
            results[(set_name, name)] = dict(ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                                             library_ms=lib_ms, library_graph_ms=lib_g_ms,
                                             norm_err=err, max_abs_err=abs_err, deterministic=det)
            lib_txt = (f"{lib_ms:.3f} ms, {lib_g_ms:.4f} by graph replay (its own error "
                       f"{lib_err:.1e})" if lib_ms is not None else f"null ({why})")
            print(f"K4 {key} bf16 {name}, {set_name}: norm_err {err:.3e} (<= {GMM_BF16_ERR}), "
                  f"max_abs {abs_err:.3e}  median kernel {ms:.3f} ms, {g_ms:.4f} by graph replay "
                  f"({flops / g_ms / 1e9:.1f} TFLOP/s, {bd['bound_ms'] / g_ms:.3f} of the bound "
                  f"{bd['bound_ms']:.3f} ms, {bd['bound_by']})  plain {plain_ms:.3f} ms  "
                  f"torch._grouped_mm {lib_txt}; two calls bit-identical: {det}", flush=True)
            require(err <= GMM_BF16_ERR and finite and det,
                    f"K4 {name} bf16 disagrees ({set_name})")

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

    # tensor parallelism 2 (phase 31): a rank's products at F/2 (n of gmm1, k of
    # gmm2), on the router draw
    Fh, real_offs = Fd // 2, torch.cumsum(real, 0, dtype=torch.int32)
    wi_h, wo_h = wi[:, :, :Fh].contiguous(), wo[:, :Fh].contiguous()
    h_h, gh_h = h[:, :Fh].contiguous(), gh[:, :Fh].contiguous()
    bd_h = bound(flops / 2, BF16_TENSOR_FLOPS, 2.0 * (M * D + M * Fh + E * D * Fh))
    half = {}
    for name, kernel, plain, lib in (
            ("gmm1 x @ wi", lambda: gmm_ops.gmm(x, wi_h, real),
             lambda: gmm_ops.gmm_reference(x, wi_h, real),
             lambda: torch._grouped_mm(x, wi_h, offs=real_offs)),
            ("gmm2 h @ wo", lambda: gmm_ops.gmm(h_h, wo_h, real),
             lambda: gmm_ops.gmm_reference(h_h, wo_h, real),
             lambda: torch._grouped_mm(h_h, wo_h, offs=real_offs)),
            ("tgmm1 x^T dh", lambda: gmm_ops.tgmm(x, gh_h, real),
             lambda: gmm_ops.tgmm_reference(x, gh_h, real),
             lambda: torch._grouped_mm(x.t(), gh_h, offs=real_offs)),
            ("tgmm2 h^T dy", lambda: gmm_ops.tgmm(h_h, gy, real),
             lambda: gmm_ops.tgmm_reference(h_h, gy, real),
             lambda: torch._grouped_mm(h_h.t(), gy, offs=real_offs))):
        err = norm_err(kernel(), plain())
        g_ms = graph_ms(kernel)
        lib_ms, lib_g_ms, why = _library_ms(lib)
        half[name] = dict(graph_ms=g_ms, library_graph_ms=lib_g_ms, norm_err=err,
                          bound_share=bd_h["bound_ms"] / g_ms)
        print(f"K4 bf16 {name} at F/2 = {Fh} (a tensor-parallel rank's), router draw: norm_err "
              f"{err:.3e} (<= {GMM_BF16_ERR}); {g_ms:.4f} ms by graph replay, "
              f"{bd_h['bound_ms'] / g_ms:.3f} of the bound {bd_h['bound_ms']:.4f} ms "
              f"({bd_h['bound_by']}); torch._grouped_mm "
              f"{f'{lib_g_ms:.4f} ms' if lib_g_ms is not None else f'null ({why})'}", flush=True)
        require(err <= GMM_BF16_ERR, f"K4 {name} at F/2 disagrees")
    del wi_h, wo_h, h_h, gh_h

    def entry(key, name):
        r = results[("router draw", name)]
        mine = {f"{n} ({sn})": v for (sn, n), v in results.items()
                if (n.startswith("tgmm")) == (key == "tgmm")}
        return dict(max_abs_err=max_abs[key], norm_err=r["norm_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], library_ms=r["library_ms"], **bd,
                    graph_ms=r["graph_ms"], library_graph_ms=r["library_graph_ms"],
                    bound_share=bd["bound_ms"] / r["graph_ms"],
                    bound_share_by_product={p: bd["bound_ms"] / v["graph_ms"]
                                            for p, v in mine.items()},
                    deterministic=all(v["deterministic"] for v in mine.values()),
                    ms_by_product={p: v["ms"] for p, v in mine.items()},
                    graph_ms_by_product={p: v["graph_ms"] for p, v in mine.items()},
                    library_graph_ms_by_product={p: v["library_graph_ms"]
                                                 for p, v in mine.items()},
                    tp_half={p: v for p, v in half.items() if p.startswith("tgmm")
                             == (key == "tgmm")}, tp_half_bound_ms=bd_h["bound_ms"], **build)

    return entry("gmm", "gmm1 x @ wi"), entry("tgmm", "tgmm1 x^T dh")


class _RoundedPlainMha(torch.autograd.Function):
    """The plain versions of the ``dlsc_tpu_torch::mha`` op, rounding where
    the TPU kernels round: the forward rounds P to the input type before
    P·V (``mha_forward_reference(round_p=True)``), the backward P and dS
    before their products (``mha_backward_reference``)."""

    @staticmethod
    def forward(ctx, q, k, v, n_real):
        out, lse = attn_fast.mha_forward_reference(q, k, v, n_real, round_p=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.n_real = n_real
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        return (*attn_fast.mha_backward_reference(q, k, v, out, lse, dout.contiguous(),
                                                  ctx.n_real), None)


def _plain_ops(rounded: bool = False) -> dict:
    """Plain attention and grouped matmul (autograd of plain ops); with
    ``rounded``, the attention rounds where the TPU kernels round
    (``_RoundedPlainMha``). The plain grouped products sum in f32 and round
    their outputs, as the kernels do, either way."""
    attention = _RoundedPlainMha.apply if rounded else attn_fast.mha_forward_reference
    return dict(attention=attention, grouped_matmul=gmm_ops.gmm_reference)


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
    require(counts == _counts(k1=1, k2f=DEPTH, gmm=2 * DEPTH),
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


class ExpertTokens:
    """Kept dispatches of the tokens whose output reaches the loss, counted
    per (block, expert) on the card through each MoE layer's ``route_hook``
    (``models/moe.py``: every lowering and router reports its kept
    assignments; a remat re-forward counts again). Every real token's
    output reaches the loss through the later blocks' attention, except in
    the last block, whose output the head reads only at the CLS row: there
    only the CLS token counts (an expert that got other tokens of the last
    block only has no gradient). Counts are only read for "> 0"."""

    def __init__(self, model, n_real: int):
        self.n_real, self.last = n_real, len(model.blocks) - 1
        self.counts = torch.zeros(len(model.blocks), model.config["moe"]["n_experts"],
                                  dtype=torch.int64, device=next(model.parameters()).device)
        self.layers = {i: b.moe for i, b in enumerate(model.blocks) if hasattr(b, "moe")}
        for i, moe in self.layers.items():
            moe.route_hook = functools.partial(self._kept, i)

    def _kept(self, i: int, kept: torch.Tensor) -> None:
        rows = 1 if i == self.last else self.n_real
        self.counts[i] += kept[:, :rows].sum((0, 1)).round().long()

    def idle(self) -> list[tuple[int, int]]:
        """The (block, expert) pairs of the MoE blocks that got no counted
        token; removes the hooks."""
        for moe in self.layers.values():
            moe.route_hook = None
        counts = self.counts.cpu()
        return [(i, e) for i in self.layers for e in range(counts.shape[1])
                if counts[i, e] == 0]


def phase_moe_train(dev: torch.device, seed: int, card: str) -> tuple[dict, dict]:
    """AST-MoE training at ``scripts/bench.py --model ast_moe``'s
    configuration, batch 64, with the routes counted per (block, expert)
    (``ExpertTokens``): every parameter must change, and every expert that
    got a token whose output reaches the loss."""
    step, state, ms, wave, labels = bench.build(TRAIN_BATCH, seed, dev, "ast_moe")
    routed = ExpertTokens(state.model, MOE_N_REAL)
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
    # every expert of every block that got a token whose output reaches the
    # loss (ExpertTokens): each (E, ...) slice of the expert tensors; an
    # expert that got none has no gradient
    idle = routed.idle()
    experts = [(k, e) for k, p in named.items() if k.split(".")[-1] in ("wi", "bi", "wo", "bo")
               for e in range(p.shape[0])
               if (int(k.split(".")[1]), e) not in idle and torch.equal(before[k][e], p[e])]
    del before
    print(f"AST-MoE routes over {n} steps (forward and remat re-forward; the last block's CLS "
          f"token only): per block, fewest and most pairs an expert got "
          f"{[(int(c.min()), int(c.max())) for c in routed.counts.cpu()]}; (block, expert) "
          f"with none: {idle} ({len(idle)})", flush=True)
    prof = bench.profile_steps(step, state, ms, wave, labels)
    means = {k: v.item() for k, v in ms.extra_means().items()}
    rec = {**bench.record(state.model, TRAIN_BATCH, step_s, losses, peak_mem, prof), **means}
    means = {k: round(v, 4) for k, v in means.items()}
    rec["experts_without_tokens"] = len(idle)
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
    require(counts == _counts(k1=n, k2f=DEPTH * n, k2b=DEPTH * n, gmm=6 * DEPTH * n,
                              tgmm=2 * DEPTH * n, drop=_draws(DEPTH, True) * n),
            f"AST-MoE launch counts {counts} over {n} steps")
    return counts, dict(experts_without_tokens=len(idle), idle_experts=idle, record=rec)


class RouterTerms:
    """Each MoE block's router input X (f32, tokens x D) and the gradient G of
    its logits (tokens x E) in one run, taken through the layers'
    ``router_hook``: a tensor hook on each call's logits, so that only the
    call whose logits receive the gradient reports (a remat re-forward asks
    the router again, and its logits get none). G is the logits' whole
    gradient, the aux and z-losses' included; the router weight's gradient
    is G^T X, a sum over every token whose terms largely cancel."""

    def __init__(self, model):
        self.x, self.g = {}, {}
        self.layers = {i: b.moe for i, b in enumerate(model.blocks) if hasattr(b, "moe")}
        for i, moe in self.layers.items():
            moe.router_hook = functools.partial(self._forward, i)

    def _forward(self, i, x, logits):
        if logits.requires_grad:
            logits.register_hook(functools.partial(self._backward, i, x.detach()))

    def _backward(self, i, x, g):
        self.x[i], self.g[i] = x.reshape(-1, x.shape[-1]), g.reshape(-1, g.shape[-1])

    def remove(self) -> None:
        for moe in self.layers.values():
            moe.router_hook = None

    def scale(self, i: int, grad: torch.Tensor) -> float:
        """c max(|G|^T |X|) of block i's router: the size of its gradient's
        terms, times the clip factor c = |grad| / |G^T X| that ``grad`` (the
        momentum buffer after one step: the clipped gradient) carries."""
        x, g = self.x[i], self.g[i]
        c = grad.float().norm() / (g.T @ x).norm()
        return (c * (g.abs().T @ x.abs()).max()).item()

    def scales(self, named_grads: dict) -> dict:
        """``scale`` of every router weight, by parameter name."""
        return {name: self.scale(i, named_grads[name])
                for i in self.layers for name in [f"blocks.{i}.moe.router.weight"]}


# Faults that phase 11's sweep can plant in the bf16 kernels' run, a negative
# control of its gate (``--moe-parity-fault``); never on the default path.
MOE_PARITY_FAULTS = ("gate_detached", "tgmm_short", "gmm_scale")


def _second_gate_detached(topk):
    """``topk`` whose second choice's gate value is detached from the graph:
    the forward is unchanged, the router's gradient loses that term."""
    def detached(gates, k):
        vals, idx = topk(gates, k)
        return torch.cat([vals[..., :1], vals[..., 1:2].detach(), vals[..., 2:]], -1), idx
    return detached


def _first_group(group_sizes: torch.Tensor, rows: int) -> tuple[int, int]:
    """(start, end) of the first group of at least ``rows`` rows."""
    sizes = group_sizes.tolist()
    g = next(i for i, n in enumerate(sizes) if n >= rows)
    start = sum(sizes[:g])
    return start, start + sizes[g]


@contextlib.contextmanager
def _planted(fault: str | None):
    """Plants ``fault`` in the grouped products while it is open:
    ``tgmm_short`` leaves the last 64 rows of the first group of 64 or more
    out of K4b's input (its lhs rows zeroed); ``gmm_scale`` scales the first
    group's rows of every forward K4a output by 1 + 2^-5."""
    real_gmm, real_tgmm = gmm_ops.gmm, gmm_ops.tgmm

    def tgmm_short(lhs, grad, group_sizes):
        _, end = _first_group(group_sizes, 64)
        lhs = lhs.clone()
        lhs[end - 64:end] = 0
        return real_tgmm(lhs, grad, group_sizes)

    def gmm_scale(lhs, rhs, group_sizes, transpose_rhs=False):
        out = real_gmm(lhs, rhs, group_sizes, transpose_rhs=transpose_rhs)
        if not transpose_rhs:
            start, end = _first_group(group_sizes, 1)
            out[start:end] *= 1 + 2**-5
        return out

    if fault == "tgmm_short":
        gmm_ops.tgmm = tgmm_short
    elif fault == "gmm_scale":
        gmm_ops.gmm = gmm_scale
    try:
        yield
    finally:
        gmm_ops.gmm, gmm_ops.tgmm = real_gmm, real_tgmm


def phase_moe_parity(dev: torch.device, seed: int, readings: dict | None = None,
                     fault: str | None = None) -> dict:
    """One AST-MoE train step at full width and batch 4, dropout 0.1 with one
    seed on every side, SGD with momentum (see ``phase_parity``), each plain
    run replaying the routes of the run it is compared with. Required: f32
    through the kernels vs f32 plain ops, and bf16 through the kernels (remat
    attn_res) vs bf16 plain ops (remat attn_res) whose attention rounds where
    the TPU kernels round (``_RoundedPlainMha``). In that bf16 comparison a
    router weight's gradient error is divided by the size of its sum's terms,
    c max(|G|^T |X|) (``RouterTerms``, from the bf16 plain run), not by its
    max |ref|: G^T X cancels, so its max |ref| is far below its terms, whose
    rounding sets the error (the max-normalised reading is printed). Every
    other parameter, and the f32 comparison, keep the max-normalised error.
    Printed only: the bf16 kernels and the bf16 plain run each against f32
    plain ops on the same routes (the second is the bf16 model's own noise),
    and the bf16 kernels against f32 plain ops on the f32 run's routes.
    ``fault`` (``MOE_PARITY_FAULTS``) is planted in the bf16 kernels' run.
    Returns (and fills ``readings`` with, as they are taken) the worst
    gradient error of each bf16 comparison on the same routes."""
    readings = {} if readings is None else readings
    pipe = bench.bench_pipeline()
    rng = np.random.default_rng(seed + 2)
    wave = torch.from_numpy((rng.standard_normal((PARITY_BATCH, CLIP)) * 0.3)
                            .astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, AST_MOE["num_classes"], PARITY_BATCH)).to(dev)
    draws = pipe.draw(PARITY_BATCH, CLIP, rng)
    dropout_seed = int(rng.integers(2**62))

    def one_step(dtype, remat, plain, topk, terms=False):
        model = ASTMoE(**AST_MOE, dtype=dtype, remat=remat, device=dev,
                       generator=torch.Generator().manual_seed(seed))
        router = RouterTerms(model) if terms else None
        state = TrainState.create(model, sgd(lr=5e-4, momentum=0.9), None, 25,
                                  gradient_clip_val=1.0)
        step = make_train_step(pipe, CrossEntropyLoss(), topk=topk,
                               **(_plain_ops(rounded=dtype == torch.bfloat16) if plain else {}))
        _reset_launches()
        _, _, loss = step(state, MetricState.create(AST_MOE["num_classes"], dev, MOE_METRICS),
                          wave, labels, draws, dropout_seed)
        torch.cuda.synchronize()
        names, params = zip(*model.named_parameters())
        grads = [state.optimizer.state[p]["momentum_buffer"] for p in params]
        run = (loss.item(), grads, [p.detach() for p in params], _launch_counts(), names)
        if router is None:
            return run
        router.remove()
        return run, router.scales(dict(zip(names, grads)))

    r32, r16 = RouteLog(), RouteLog()
    k32 = one_step(torch.float32, False, False, r32.record)
    p32 = one_step(torch.float32, False, True, r32.replay(DEPTH))
    with _planted(fault):
        b16 = one_step(torch.bfloat16, True, False, _second_gate_detached(r16.record)
                       if fault == "gate_detached" else r16.record)
    # the remat re-forward asks the router again: every recorded call, in order
    q16, scales = one_step(torch.bfloat16, True, True, r16.replay(len(r16.routes)), terms=True)
    p16 = one_step(torch.float32, False, True, r16.replay(DEPTH))
    # the plain runs' dropout is the draw kernel too (the same masks)
    d32, d16 = _draws(DEPTH, False), _draws(DEPTH, True)
    require(k32[3] == _counts(k1=1, k2f=DEPTH, k2b=DEPTH, gmm=4 * DEPTH, tgmm=2 * DEPTH,
                              drop=d32)
            and b16[3] == _counts(k1=1, k2f=DEPTH, k2b=DEPTH, gmm=6 * DEPTH, tgmm=2 * DEPTH,
                                  drop=d16)
            and p32[3] == _counts(k1=1, drop=d32) and q16[3] == _counts(k1=1, drop=d16)
            and p16[3] == _counts(k1=1, drop=d32),
            f"AST-MoE parity launches {k32[3]} {p32[3]} {b16[3]} {q16[3]} {p16[3]}")
    flips = r16.flips(r32, MOE_N_REAL)
    print(f"AST-MoE step parity (seed {seed}{f', fault {fault} planted' if fault else ''}): the "
          f"bf16 run routes {flips[0]} of {flips[1]} real (token, choice) pairs otherwise than "
          f"the f32 run", flush=True)
    # the printed-only comparisons first, so that a sweep keeps every reading
    _compare_steps(b16, p16, "bf16 kernels vs f32 plain ops, same routes (AST-MoE, dropout 0.1",
                   STEP_BF16_LOSS, STEP_BF16_GRAD, False, readings, "kernels_bf16_vs_plain_f32")
    _compare_steps(q16, p16, "bf16 plain ops vs f32 plain ops, same routes: the bf16 model's "
                   "own noise (AST-MoE, dropout 0.1", STEP_BF16_LOSS, STEP_BF16_GRAD, False,
                   readings, "plain_bf16_vs_plain_f32", scales)
    _compare_steps(b16, p32, "bf16 kernels vs f32 plain ops on the f32 run's own routes "
                   "(AST-MoE, dropout 0.1", STEP_BF16_LOSS, STEP_BF16_GRAD, required=False)
    _compare_steps(b16, q16, "bf16 kernels vs bf16 plain ops rounding as the TPU kernels do, "
                   "both remat attn_res, same routes (AST-MoE, dropout 0.1", STEP_BF16_LOSS,
                   STEP_BF16_GRAD, True, readings, "kernels_bf16_vs_plain_bf16", scales)
    _compare_steps(k32, p32, "f32 kernels vs f32 plain attention and gmm, same routes "
                   "(AST-MoE, dropout 0.1", STEP_F32_LOSS, STEP_F32_GRAD)
    return readings


# --- phase 12: kernel K3 ----------------------------------------------------------

def _unfused_add_ln(x, delta, gamma, beta):
    """The block's site that K3 replaces: the residual add, then the port's
    LayerNorm (cast to f32, ``F.layer_norm``, cast back)."""
    r = x + delta
    return r, F.layer_norm(r.float(), (x.shape[-1],), gamma, beta, ln_fused.EPS).to(x.dtype)


def _ln_bytes(rows: int, d: int, elem: int) -> int:
    """What K3f and K3b each must move: four (rows, d) tensors of ``elem``
    bytes (forward x, delta in, r, y out; backward r, dr, dy in, dx out),
    the two f32 row statistics, and gamma, beta (or dgamma, dbeta)."""
    return 4 * rows * d * elem + 2 * rows * 4 + 2 * d * 4


def _library_ln(r, mu, rsig, gamma, beta, dy):
    """PyTorch's own LayerNorm backward on the stored r and statistics
    (``aten.native_layer_norm_backward``): dy → (d r, dgamma, dbeta), all of
    K3b's work but the dr add. gamma and beta in r's type, as the CUDA op
    reads its weight in its input's type."""
    return torch.ops.aten.native_layer_norm_backward(
        dy, r, (r.shape[-1],), mu, rsig, gamma.to(r.dtype), beta.to(r.dtype), [True] * 3)


def phase_ln(dev: torch.device, gen: torch.Generator) -> tuple[dict, dict]:
    """K3f and K3b against their plain versions at the training batch's
    three widths in bf16 and at AST-Small's in f32, each beside the unfused
    site (forward, and autograd's backward: its forward and backward less
    its forward) and PyTorch's own LayerNorm (``aten.native_layer_norm`` on
    r, ``aten.native_layer_norm_backward``, ``_library_ln``); two K3b calls
    bit-identical at each. Registers and no spill in any K3 kernel
    (``-Xptxas -v``). Times are device times (``graph_ms``): a K3 call is
    shorter than its Python.
    Bounds by bytes; operations counted as 8 f32 operations per element
    forward (add, two sums, centre, square, scale, gamma, beta) and 12
    backward."""
    build = _build_report("ln_fused")
    g = torch.Generator(dev).manual_seed(int(torch.randint(2**31, (1,), generator=gen)))
    cases = [(shape, torch.bfloat16) for shape in LN_SHAPES] + [(LN_SHAPES[0], torch.float32)]
    fwd, bwd = {}, {}
    for (name, rows, d), dtype in cases:
        x, delta, dr, dy = (torch.randn(rows, d, generator=g, device=dev).to(dtype)
                            for _ in range(4))
        gamma = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
        beta = 0.1 * torch.randn(d, generator=g, device=dev)
        tol = LN_F32_ERR if dtype == torch.float32 else LN_BF16_ERR
        got = ln_fused.fused_add_ln_forward(x, delta, gamma, beta)
        want = ln_fused.add_ln_reference(x, delta, gamma, beta)
        r_exact = torch.equal(got[0], want[0])
        f_errs = [norm_err(a, b) for a, b in zip(got[1:], want[1:])]   # y, mu, rsig
        f_abs = (got[1].float() - want[1].float()).abs().max().item()
        r, _, mu, rsig = got
        bgot = ln_fused.fused_add_ln_backward(r, mu, rsig, gamma, dr, dy)
        bwant = ln_fused.add_ln_backward_reference(r, mu, rsig, gamma, dr, dy)
        b_errs = [norm_err(a, b) for a, b in zip(bgot, bwant)]         # dx, dgamma, dbeta
        b_abs = max((a.float() - b.float()).abs().max().item() for a, b in zip(bgot, bwant))
        finite = all(torch.isfinite(t).all().item() for t in (*got, *bgot))
        rerun = ln_fused.fused_add_ln_backward(r, mu, rsig, gamma, dr, dy)
        det = all(torch.equal(a, b) for a, b in zip(bgot, rerun))
        del got, want, bgot, bwant, rerun
        leaves = [t.detach().requires_grad_() for t in (x, delta, gamma, beta)]
        fns = dict(
            f=lambda: ln_fused.fused_add_ln_forward(x, delta, gamma, beta),
            f_plain=lambda: ln_fused.add_ln_reference(x, delta, gamma, beta),
            f_unf=lambda: _unfused_add_ln(x, delta, gamma, beta),
            f_lib=lambda: torch.ops.aten.native_layer_norm(r, (d,), gamma.to(dtype),
                                                           beta.to(dtype), ln_fused.EPS),
            b=lambda: ln_fused.fused_add_ln_backward(r, mu, rsig, gamma, dr, dy),
            b_plain=lambda: ln_fused.add_ln_backward_reference(r, mu, rsig, gamma, dr, dy),
            b_lib=lambda: _library_ln(r, mu, rsig, gamma, beta, dy),
            fb_unf=lambda: torch.autograd.grad(_unfused_add_ln(*leaves), leaves, (dr, dy)))
        # device time of each (graph replays); CUDA events per call for the kernels beside it
        t = {k: graph_ms(fn) for k, fn in fns.items()}
        t["b_unf"] = t.pop("fb_unf") - t["f_unf"]   # autograd's backward of the unfused site
        f_call, b_call = (float(np.median(cuda_times(fns[k]))) for k in ("f", "b"))
        split = _split_ms(fns["b"], dict(rows=r"add_ln_bwd_kernel",
                                         reduce=r"add_ln_bwd_reduce_kernel"), "K3b")
        del leaves
        nbytes = _ln_bytes(rows, d, x.element_size())
        bf = bound(LN_FWD_OPS * rows * d, F32_FLOPS, nbytes)
        bb = bound(LN_BWD_OPS * rows * d, F32_FLOPS, nbytes)
        dt = str(dtype).removeprefix("torch.")
        key = f"{name} ({rows}, {d}) {dt}"
        plan = ln_fused._bwd_plan(rows, d, torch.cuda.get_device_properties(dev)
                                  .multi_processor_count, x.element_size())
        print(f"K3 add_ln at {key}: r exact {r_exact}; forward y {f_errs[0]:.3e} mu "
              f"{f_errs[1]:.3e} rsig {f_errs[2]:.3e}, backward dx {b_errs[0]:.3e} dgamma "
              f"{b_errs[1]:.3e} dbeta {b_errs[2]:.3e} normalised (<= {tol}); K3b reruns "
              f"bit-identical {det}; device ms (graph replays): K3f {t['f']:.4f} (plain "
              f"{t['f_plain']:.4f}, unfused site {t['f_unf']:.4f}, native_layer_norm "
              f"{t['f_lib']:.4f}), K3b {t['b']:.4f} (plain {t['b_plain']:.4f}, unfused autograd "
              f"{t['b_unf']:.4f}, native_layer_norm_backward {t['b_lib']:.4f}); per call (CUDA "
              f"events) K3f {f_call:.4f}, K3b {b_call:.4f}; K3b's kernels (profiler): rows "
              f"{split['rows']:.4f}, sum of the partials {split['reduce']:.4f}; bound {bf['bound_ms']:.4f} ms "
              f"({bf['bound_by']}, {nbytes / 1e6:.1f} MB): K3f at {bf['bound_ms'] / t['f']:.1%}, "
              f"K3b at {bb['bound_ms'] / t['b']:.1%} of it; K3b plan: tiles of "
              f"{plan['tile_rows']} rows, {plan['lanes']} lanes a row, {plan['stages']} stages "
              f"of {plan['stage_bytes']} B, grid {plan['grid']}", flush=True)
        require(r_exact and finite and max(f_errs) <= tol and max(b_errs) <= tol,
                f"K3 disagrees with its plain version at {key}")
        require(det, f"K3b reruns differ at {key}")
        fwd[key] = dict(max_abs_err=f_abs, ms=t["f"], call_ms=f_call, plain_ms=t["f_plain"],
                        library_ms=t["f_lib"], unfused_ms=t["f_unf"], **bf)
        bwd[key] = dict(max_abs_err=b_abs, ms=t["b"], call_ms=b_call, plain_ms=t["b_plain"],
                        library_ms=t["b_lib"], unfused_ms=t["b_unf"], deterministic=det,
                        kernels_ms=split, **bb)
        del x, delta, dr, dy, r, mu, rsig

    def entry(results, kernels):
        main = results[f"{LN_SHAPES[0][0]} ({LN_SHAPES[0][1]}, {LN_SHAPES[0][2]}) bfloat16"]
        return dict(max_abs_err=max(v["max_abs_err"] for v in results.values()),
                    ms=main["ms"], call_ms=main["call_ms"], plain_ms=main["plain_ms"],
                    bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                    library_ms=main["library_ms"], unfused_ms=main["unfused_ms"],
                    registers={k: v for k, v in build["registers"].items()
                               if k.split("<")[0] in kernels},
                    spill_store_bytes={k: v for k, v in build["spill_store_bytes"].items()
                                       if k.split("<")[0] in kernels},
                    by_shape=results)

    return (entry(fwd, ("add_ln_fwd_kernel",)),
            entry(bwd, ("add_ln_bwd_kernel", "add_ln_bwd_reduce_kernel")))


# --- phase 13: K2 at the shapes of K5 and K6 ------------------------------------------

def _attn_case(dev: torch.device, g: torch.Generator, B: int, H: int, N: int, n_real: int,
               dtype: torch.dtype) -> dict:
    """K2f and K2b on one shape against their plain versions (one batch row
    at a time), timed beside SDPA (boolean key mask when n_real < N); two
    calls of each must give the same bits."""
    q, k, v, do = (torch.randn(B, H, N, 64, generator=g, device=dev) for _ in range(4))
    q = q * 64**-0.5
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
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
    errs = [norm_err(a[:, :, rows], b[:, :, rows]) for a, b in zip(got, want)]
    b_abs = max((a - b)[:, :, rows].float().abs().max().item() for a, b in zip(got, want))
    zero_tails = all((a[:, :, n_real:] == 0).all().item() for a in got[1:])
    finite = all(torch.isfinite(t).all().item() for t in (out, *got))
    again = attn_fast.fast_mha_backward(q, k, v, out, lse, do, n_real)
    fwd_det = _reruns_equal(lambda: attn_fast.fast_mha_forward(q, k, v, n_real))
    deterministic = fwd_det and all(torch.equal(a, b) for a, b in zip(got, again))
    del got, want, again
    mask = None if n_real == N else _key_mask(N, n_real, dev)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)

    o = sdpa(qr, kr, vr)
    calls = dict(f=lambda: attn_fast.fast_mha_forward(q, k, v, n_real),
                 b=lambda: attn_fast.fast_mha_backward(q, k, v, out, lse, do, n_real),
                 lib_f=lambda: sdpa(q, k, v),
                 lib_b=lambda: torch.autograd.grad(o, (qr, kr, vr), do, retain_graph=True))
    f_ms, b_ms, lib_f, lib_b = (float(np.median(cuda_times(fn))) for fn in calls.values())
    # device time (graph replays); SDPA's masked backward refuses capture (the
    # autograd engine makes the legacy stream wait on the capturing one), so
    # it keeps its CUDA-event time
    dev_ms = {k: graph_ms(calls[k], reps=5) for k in ("f", "b", "lib_f")}
    del o, qr, kr, vr
    peak = BF16_TENSOR_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    elem = q.element_size()
    bf = bound(4 * B * H * N * n_real * 64, peak, _attn_bytes(B, H, N, 64, 4, elem))
    bb = bound(10 * B * H * N * n_real * 64, peak, _attn_bytes(B, H, N, 64, 8, elem))
    f_tol, b_tol = ((ATTN_F32_ERR, BWD_F32_ERR) if dtype == torch.float32
                    else (ATTN_BF16_ERR, BWD_BF16_ERR))
    dt = str(dtype).removeprefix("torch.")
    print(f"K2 at ({B}, {H}, {N}, 64) n_real {n_real} {dt}: attn_fwd out {e_out:.3e} lse "
          f"{e_lse:.3e} (<= {f_tol}), {f_ms:.3f} ms (SDPA {lib_f:.3f}, bound "
          f"{bf['bound_ms']:.3f}); attn_bwd dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
          f"normalised (<= {b_tol}), dK/dV rows >= n_real exactly 0: {zero_tails}, "
          f"{b_ms:.3f} ms (SDPA backward {lib_b:.3f}, bound {bb['bound_ms']:.3f}), two calls "
          f"bit-identical: {deterministic}; CUDA events per call; device ms (graph replays) "
          f"{dict((k, round(v, 4)) for k, v in dev_ms.items())}",
          flush=True)
    require(e_out <= f_tol and e_lse <= f_tol and max(errs) <= b_tol and zero_tails and finite
            and deterministic, f"K2 disagrees at ({B}, {H}, {N}, 64) n_real {n_real} {dt}")
    return dict(fwd=dict(ms=f_ms, device_ms=dev_ms["f"], max_abs_err=max(e_out, e_lse),
                         library_ms=lib_f, library_device_ms=dev_ms["lib_f"], **bf),
                bwd=dict(ms=b_ms, device_ms=dev_ms["b"], max_abs_err=b_abs, norm_err=max(errs),
                         library_ms=lib_b, **bb))


def phase_attn_k5_k6(dev: torch.device, gen: torch.Generator) -> dict:
    """K2 at the shapes that only K5 and K6 reached on the TPU: the longest
    sequence the 10-s positional table admits (AST-Base, n_pad 3328) and
    n_real == N (no masked key, no boundary tile)."""
    g = torch.Generator(dev).manual_seed(int(torch.randint(2**31, (1,), generator=gen)))
    cases = {}
    for dtype in (torch.bfloat16, torch.float32):
        key = f"({SERVE_BATCH}, {HEADS}, {LONG_N_PAD}, 64) n_real {LONG_N_REAL} {str(dtype)[6:]}"
        cases[key] = _attn_case(dev, g, SERVE_BATCH, HEADS, LONG_N_PAD, LONG_N_REAL, dtype)
        torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        key = f"({SERVE_BATCH}, {MOE_HEADS}, {MOE_N_PAD}, 64) n_real {MOE_N_PAD} {str(dtype)[6:]}"
        cases[key] = _attn_case(dev, g, SERVE_BATCH, MOE_HEADS, MOE_N_PAD, MOE_N_PAD, dtype)
    return cases


# --- phases 14-17: AST-Small and AST-Mini ----------------------------------------------

def _plain_dense_ops() -> dict:
    return dict(attention=attn_fast.mha_forward_reference, add_ln=ln_fused.add_ln_reference)


def _hold_served(served, pipe, clips: np.ndarray, dev: torch.device, what: str) -> None:
    """One fixed batch: the served model's weights in f32 through the
    kernels, and the served model itself, against the weights in f32 with
    plain attention and the plain add + LN on the plain features."""
    wave = torch.from_numpy(clips).to(dev)
    feats = pipe.eval_batch(wave)
    feats_plain = M.ast_normalize(M.log_mel_spectrogram(wave))
    ref32 = ASTViT(**{**served.config, "dtype": "float32"})
    ref32.load_state_dict(served.state_dict())
    ref32.to(dev)
    with torch.inference_mode():
        want = ref32(feats_plain, **_plain_dense_ops())
        got32 = ref32(feats)
        got16 = served(feats)
    e32 = (got32 - want).abs().max().item()
    e16 = (got16 - want).abs().max().item()
    require(torch.isfinite(got16).all().item() and got16.shape == want.shape,
            f"{what} served outputs not finite or misshaped")
    print(f"{what} pre-softmax (sigmoid) outputs vs plain attention and plain add + LN in f32, "
          f"batch {clips.shape[0]}: kernels f32 {e32:.3e} (<= {SLICE_F32_ERR}), served bf16 "
          f"{e16:.3e} (<= {SLICE_BF16_ERR})", flush=True)
    require(e32 <= SLICE_F32_ERR, f"{what} f32 through the kernels disagrees with plain ops")
    require(e16 <= SLICE_BF16_ERR, f"{what} bf16 served outputs disagree with plain ops")


def phase_small_slice(dev: torch.device, seed: int, tmp: Path, card: str) -> dict:
    """AST-Small serving with ``ln_fused`` and K6's selector, exported by the
    CLI; one batch of 8, the comparison with plain ops, throughput."""
    from dlsc_tpu_torch.scripts import export

    art = export.main(["model=ast_small", f"+out={tmp / 'ast_small'}", "+model.ln_fused=true",
                       "+model.attn_impl=flash", f"+seed={seed}", f"+batch={SERVE_BATCH}"])
    serve = load_exported(art, device="cuda")
    kw = serve.manifest["model_kwargs"]
    require((kw["emb_dim"], kw["depth"], kw["patch_stride"], kw["ln_fused"], kw["attn_impl"])
            == (384, DEPTH, AST_SMALL["patch_stride"], True, "flash"),
            f"AST-Small artifact's model {kw}")
    rng = np.random.default_rng(seed + 5)
    clips = (rng.standard_normal((SERVE_BATCH, CLIP)) * 0.1).astype(np.float32)
    serve(clips)   # warm-up: cuBLAS handles, allocator

    # --- the main path: only these launches are counted ---------------------
    _reset_launches()
    probs = serve(clips)
    torch.cuda.synchronize()
    counts = _launch_counts()
    # --------------------------------------------------------------------------
    print(f"AST-Small (ln_fused, attn_impl flash) served one batch of {SERVE_BATCH}: launches "
          f"{counts}", flush=True)
    require(probs.shape == (SERVE_BATCH, AST_SMALL["num_classes"]) and np.isfinite(probs).all()
            and np.abs(probs.sum(-1) - 1.0).max() <= PROB_SUM_ERR,
            "AST-Small probabilities not finite, misshaped or not summing to 1")
    require(counts == _counts(k1=1, k2f=DEPTH, k3f=DEPTH),
            f"AST-Small serving launch counts {counts} for one device batch")
    _hold_served(serve.model, serve.pipe, clips, dev, "AST-Small")

    infer = make_infer(serve.model, serve.pipe)
    for b in (SERVE_BATCH, 64):
        wave = (torch.randn(b, CLIP, generator=torch.Generator().manual_seed(seed)) * 0.1).to(dev)
        ms = float(np.median(cuda_times(lambda: infer(wave), iters=10)))
        prof = bench.profile_calls(lambda: infer(wave), n=3, top=8)
        print(f"AST-Small serving throughput, batch {b} (device-resident waves, CUDA events, "
              f"median of 10): {ms:.3f} ms/batch, {b / ms * 1e3:.1f} clips/s; profiled: "
              f"{prof['device_ms_per_call']:.1f} ms of kernels ({prof['kernels_per_call']:.0f} "
              f"launches) in {prof['wall_ms_per_call']:.1f} ms, busy share "
              f"{prof['busy_share']:.3f}, kinds "
              f"{dict((k, round(v, 2)) for k, v in prof['by_kind_ms'].items())}  [{card}]",
              flush=True)
    return counts


def _train_run(dev: torch.device, seed: int, model_name: str, warmup: int, steps: int):
    """``scripts/bench.py --model <model_name> --ln-fused``'s steps, counted
    from 0: (record, launch counts, losses, parameters that did not change)."""
    step, state, ms, wave, labels = bench.build(TRAIN_BATCH, seed, dev, model_name,
                                                ln_fused=True)
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    torch.cuda.reset_peak_memory_stats(dev)

    # --- the main path: only these launches are counted ---------------------
    _reset_launches()
    state, ms, losses, step_s = bench.timed_steps(step, state, ms, wave, labels, warmup, steps)
    counts = _launch_counts()
    # --------------------------------------------------------------------------
    peak_mem = torch.cuda.max_memory_allocated(dev) / 2**30
    unchanged = [k for k, p in state.model.named_parameters() if torch.equal(before[k], p)]
    del before
    return step, state, ms, wave, labels, step_s, peak_mem, counts, losses, unchanged


def phase_small_train(dev: torch.device, seed: int, card: str, base_step_ms: float) -> dict:
    """AST-Small training at ``bench.py --model ast_small --ln-fused``'s
    configuration, batch 64; then AST-Base ``--ln-fused``, timed beside
    phase 5's default run."""
    n = WARMUP_STEPS + TIMED_STEPS
    step, state, ms, wave, labels, step_s, peak_mem, counts, losses, unchanged = _train_run(
        dev, seed, "ast_small", WARMUP_STEPS, TIMED_STEPS)
    prof = bench.profile_steps(step, state, ms, wave, labels)
    rec = bench.record(state.model, TRAIN_BATCH, step_s, losses, peak_mem, prof)
    dec = rec["decomp"]
    print(f"train: AST-Small bf16 ln_fused remat attn_res dropout 0.1, batch {TRAIN_BATCH}, "
          f"{WARMUP_STEPS} warm-up + {TIMED_STEPS} timed steps: {rec['step_ms']:.3f} ms/step, "
          f"{rec['value']:.2f} clips/s, MFU {rec['mfu']:.4f} (hw_util {rec['hw_util']:.4f}), "
          f"peak memory {rec['peak_mem_gib']:.2f} GiB; losses {losses[0]:.4f} .. "
          f"{losses[-1]:.4f}; launches per step { {k: v / n for k, v in counts.items()} }; "
          f"profiled: busy share {prof['busy_share']:.3f}, K2f {dec['attn_fwd_ms']:.1f} + K2b "
          f"{dec['attn_bwd_ms']:.1f} + K3f {dec['ln_fwd_ms']:.1f} + K3b {dec['ln_bwd_ms']:.1f} "
          f"ms of {prof['device_ms_per_step']:.1f} ms device time per step  [{card}]",
          flush=True)
    print(json.dumps(rec), flush=True)
    require(not unchanged, f"AST-Small parameters that did not change: {unchanged[:8]}")
    require(counts == _counts(k1=n, k2f=DEPTH * n, k2b=DEPTH * n, k3f=2 * DEPTH * n,
                              k3b=DEPTH * n, drop=_draws(DEPTH, True) * n),
            f"AST-Small launch counts {counts} over {n} steps")
    del step, state, ms, wave, labels
    torch.cuda.empty_cache()

    *_, b_step_s, b_peak, b_counts, b_losses, b_unchanged = _train_run(
        dev, seed, "ast", WARMUP_STEPS, TIMED_STEPS)
    print(f"train: AST-Base bf16 with ln_fused, batch {TRAIN_BATCH}, {WARMUP_STEPS} warm-up + "
          f"{TIMED_STEPS} timed steps: {b_step_s * 1e3:.3f} ms/step ({TRAIN_BATCH / b_step_s:.2f} "
          f"clips/s; phase 5's default run, unfused: {base_step_ms:.3f} ms/step), peak memory "
          f"{b_peak:.2f} GiB; launches per step { {k: v / n for k, v in b_counts.items()} }  "
          f"[{card}]", flush=True)
    require(not b_unchanged and np.isfinite(b_losses).all(), "AST-Base ln_fused run")
    require(b_counts == _counts(k1=n, k2f=DEPTH * n, k2b=DEPTH * n, k3f=2 * DEPTH * n,
                                k3b=DEPTH * n),
            f"AST-Base ln_fused launch counts {b_counts} over {n} steps")
    return counts


def phase_small_parity(dev: torch.device, seed: int) -> None:
    """One AST-Small train step with ``ln_fused`` at full width and batch 4,
    dropout 0.1 with one seed, SGD with momentum (see ``phase_parity``): f32
    through K2 and K3 vs f32 plain ops, and bf16 through the kernels (remat
    attn_res) vs that f32 plain step."""
    pipe = bench.bench_pipeline()
    rng = np.random.default_rng(seed + 6)
    wave = torch.from_numpy((rng.standard_normal((PARITY_BATCH, CLIP)) * 0.3)
                            .astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, AST_SMALL["num_classes"], PARITY_BATCH)).to(dev)
    draws = pipe.draw(PARITY_BATCH, CLIP, rng)
    dropout_seed = int(rng.integers(2**62))

    def one_step(dtype, remat, plain):
        model = ASTViTSmall(**AST_SMALL, dtype=dtype, remat=remat, ln_fused=True, device=dev,
                            generator=torch.Generator().manual_seed(seed))
        state = TrainState.create(model, sgd(lr=5e-4, momentum=0.9), None, 25,
                                  gradient_clip_val=1.0)
        step = make_train_step(pipe, CrossEntropyLoss(), **(_plain_dense_ops() if plain else {}))
        _reset_launches()
        _, _, loss = step(state, MetricState.create(AST_SMALL["num_classes"], dev), wave,
                          labels, draws, dropout_seed)
        torch.cuda.synchronize()
        names, params = zip(*model.named_parameters())
        return (loss.item(), [state.optimizer.state[p]["momentum_buffer"] for p in params],
                [p.detach() for p in params], _launch_counts(), names)

    k32 = one_step(torch.float32, False, False)
    p32 = one_step(torch.float32, False, True)
    b16 = one_step(torch.bfloat16, True, False)
    d32, d16 = _draws(DEPTH, False), _draws(DEPTH, True)
    require(k32[3] == _counts(k1=1, k2f=DEPTH, k2b=DEPTH, k3f=DEPTH, k3b=DEPTH, drop=d32)
            and p32[3] == _counts(k1=1, drop=d32)
            and b16[3] == _counts(k1=1, k2f=DEPTH, k2b=DEPTH, k3f=2 * DEPTH, k3b=DEPTH,
                                  drop=d16),
            f"AST-Small parity launches {k32[3]} {p32[3]} {b16[3]}")
    _compare_steps(k32, p32, "f32 K2 + K3 vs f32 plain attention and add + LN (AST-Small "
                   "ln_fused, dropout 0.1", STEP_F32_LOSS, STEP_F32_GRAD)
    _compare_steps(b16, p32, "bf16 kernels (remat attn_res) vs f32 plain ops (AST-Small "
                   "ln_fused, dropout 0.1", STEP_BF16_LOSS, STEP_BF16_GRAD)


def phase_mini(dev: torch.device, seed: int, tmp: Path, card: str) -> tuple[dict, dict]:
    """AST-Mini with ``ln_fused``: one served batch of 8 (K2 at 3 heads, K3 at
    width 192) against plain ops, then 2 train steps at batch 64."""
    model = ASTMiniViT(**AST_MINI, ln_fused=True, generator=torch.Generator().manual_seed(seed))
    pipe = DevicePipeline(PipelineConfig(mode="ast", num_classes=AST_MINI["num_classes"]))
    art = export_model(model, pipe, tmp / "ast_mini", batch=SERVE_BATCH, clip_samples=CLIP)
    del model
    serve = load_exported(art, device="cuda")
    rng = np.random.default_rng(seed + 7)
    clips = (rng.standard_normal((SERVE_BATCH, CLIP)) * 0.1).astype(np.float32)
    serve(clips)   # warm-up

    # --- the main path (serving): only these launches are counted ------------
    _reset_launches()
    probs = serve(clips)
    torch.cuda.synchronize()
    serve_counts = _launch_counts()
    # --------------------------------------------------------------------------
    print(f"AST-Mini (ln_fused) served one batch of {SERVE_BATCH}: launches {serve_counts}",
          flush=True)
    require(probs.shape == (SERVE_BATCH, AST_MINI["num_classes"]) and np.isfinite(probs).all()
            and np.abs(probs.sum(-1) - 1.0).max() <= PROB_SUM_ERR,
            "AST-Mini probabilities not finite, misshaped or not summing to 1")
    require(serve_counts == _counts(k1=1, k2f=MINI_DEPTH, k3f=MINI_DEPTH),
            f"AST-Mini serving launch counts {serve_counts}")
    _hold_served(serve.model, serve.pipe, clips, dev, "AST-Mini")
    del serve
    torch.cuda.empty_cache()

    steps = 2
    *_, step_s, peak_mem, counts, losses, unchanged = _train_run(dev, seed, "ast_mini", 0, steps)
    print(f"train: AST-Mini bf16 ln_fused dropout 0.1 no remat, batch {TRAIN_BATCH}, {steps} "
          f"steps: {step_s * 1e3:.3f} ms/step (no warm-up), peak memory {peak_mem:.2f} GiB; "
          f"losses {[round(float(x), 4) for x in losses]}; launches {counts}  [{card}]",
          flush=True)
    require(not unchanged, f"AST-Mini parameters that did not change: {unchanged[:8]}")
    require(counts == _counts(k1=steps, k2f=MINI_DEPTH * steps, k2b=MINI_DEPTH * steps,
                              k3f=MINI_DEPTH * steps, k3b=MINI_DEPTH * steps,
                              drop=_draws(MINI_DEPTH, False) * steps),
            f"AST-Mini launch counts {counts} over {steps} steps")
    return serve_counts, counts


# --- phase 18: the trainer slice (the train, evaluate, predict and export CLIs) --------

TRAINER_CLASSES, TRAINER_CLIPS, TRAINER_FOLDS = 50, 4, 5   # ESC-50's layout, 1000 clips
TRAINER_EPOCHS = 2
TEST_LOSS_REL = 1e-5    # the same weights and clips through the same kernels: the pool's
                        # gather against host batches changes no arithmetic
PREDICT_PROB_ERR = 1e-2  # bf16 model: the checkpoint mode runs its 6 windows as one
                         # batch, the artifact in padded batches of 8, so GEMM tiling differs


def _trainer_shapes(n_train_pool: int, n_test: int, batch: int) -> dict:
    """Steps and eval batches of one fit + test of the train CLI: the val
    split is ceil(10%) of the pool (``_stratified_split``), train batches
    drop the last partial one, eval batches keep it."""
    n_val = -(-n_train_pool // 10)
    steps = (n_train_pool - n_val) // batch
    val_batches = -(-n_val // batch)
    test_batches = -(-n_test // batch)
    return dict(steps=steps, val_batches=val_batches, test_batches=test_batches)


def _dir_mb(path: Path) -> float:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file()) / 1e6


def phase_trainer(dev: torch.device, seed: int, tmp: Path, card: str,
                  bench_clips_s: float | None = None) -> dict:
    """The training entry point end to end at AST-Base's full width and
    depth: synthetic ESC-50-layout shards, ``scripts/train.py`` (2 epochs,
    bf16, batch 64, the device pool), test from the pool and from host
    batches, ``scripts/evaluate.py`` on the best checkpoint, ``predict`` in
    checkpoint and artifact modes, and an ``auto_resume`` run. Returns the
    train CLI's launch counts."""
    from dlsc_tpu_torch.config import compose
    from dlsc_tpu_torch.data.synthetic import make_synthetic_dataset, synth_clip
    from dlsc_tpu_torch.scripts import evaluate, export, predict
    from dlsc_tpu_torch.scripts import train as train_cli
    from dlsc_tpu_torch.train.loop import Trainer

    os.environ["DLSC_TRACKING_DIR"] = str(tmp / "runs")
    t0 = time.perf_counter()
    make_synthetic_dataset(tmp / "data", num_classes=TRAINER_CLASSES,
                           clips_per_class_per_fold=TRAINER_CLIPS, n_folds=TRAINER_FOLDS,
                           clip_samples=CLIP, seed=seed)
    data_s = time.perf_counter() - t0
    per_fold = TRAINER_CLASSES * TRAINER_CLIPS
    print(f"trainer: {TRAINER_FOLDS * per_fold} synthetic clips ({TRAINER_FOLDS} folds, "
          f"{TRAINER_CLASSES} classes, 5 s, PCM16, {_dir_mb(tmp / 'data'):.0f} MB) written in "
          f"{data_s:.2f} s  [{card}]", flush=True)
    common = [f"dataset.root={tmp / 'data'}", "dataset.fold=0", "trainer.precision=bf16-mixed",
              f"batch_size={TRAIN_BATCH}", f"checkpoint.dirpath={tmp / 'ckpt'}",
              "+checkpoint.save_last=true", f"hydra.run.dir={tmp / 'run'}", f"seed={seed}"]
    shapes = _trainer_shapes((TRAINER_FOLDS - 1) * per_fold, per_fold, TRAIN_BATCH)
    steps = TRAINER_EPOCHS * shapes["steps"]
    evals = TRAINER_EPOCHS * shapes["val_batches"] + shapes["test_batches"]

    # --- the main path: only these launches are counted ---------------------
    _reset_launches()
    t0 = time.perf_counter()
    res = train_cli.main(["model=ast", *common, f"trainer.max_epochs={TRAINER_EPOCHS}"])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = _launch_counts()
    # --------------------------------------------------------------------------
    trainer = res.pop("trainer")
    hist = trainer.history
    best = trainer.ckpt_manager.best_path
    last = best.parent / "last"
    require([h["epoch"] for h in hist] == list(range(TRAINER_EPOCHS)),
            f"trainer epochs {[h['epoch'] for h in hist]}")
    require(all(np.isfinite(h["train/loss"]) and "val/acc" in h for h in hist),
            f"trainer epoch metrics {hist}")
    require(best.is_dir() and (best / "state.pt").exists() and (last / "state.pt").exists(),
            f"checkpoints {best}, {last}")
    require(trainer._use_device_data, "the device-resident pool was not used")
    require(all(np.isfinite(res[k]) for k in ("test/acc", "test/f1", "test/auroc", "test/loss"))
            and all(0.0 <= res[k] <= 1.0 for k in ("test/acc", "test/f1", "test/auroc")),
            f"test metrics {res}")
    require(counts == _counts(k1=steps + evals, k2f=DEPTH * (steps + evals), k2b=DEPTH * steps),
            f"trainer launch counts {counts}: {steps} train steps, {evals} eval batches")
    clips_s = hist[-1]["perf/clips_per_sec_per_chip"]
    ratio = "" if bench_clips_s is None else (
        f"; phase 5's bench {bench_clips_s:.2f} clips/s, ratio {clips_s / bench_clips_s:.4f}")
    ckpt_mb = _dir_mb(last)
    print(f"trainer: AST-Base bf16 batch {TRAIN_BATCH}, {TRAINER_EPOCHS} epochs x "
          f"{shapes['steps']} steps (device pool): fit {trainer.fit_seconds:.2f} s, train "
          f"CLI (fit + test) {main_s:.2f} s; epoch {TRAINER_EPOCHS - 1} "
          f"{clips_s:.2f} clips/s{ratio}; epoch 0 {hist[0]['perf/clips_per_sec_per_chip']:.2f}"
          f" clips/s; checkpoint writes {len(trainer.ckpt_manager.write_seconds)} x "
          f"{ckpt_mb:.0f} MB in {', '.join(f'{t:.2f}' for t in trainer.ckpt_manager.write_seconds)}"
          f" s; train/loss {[round(h['train/loss'], 4) for h in hist]}, val/acc "
          f"{[round(h['val/acc'], 4) for h in hist]}; test acc {res['test/acc']:.4f} F1 "
          f"{res['test/f1']:.4f} AUROC {res['test/auroc']:.4f} loss {res['test/loss']:.4f}; "
          f"launches {counts}  [{card}]", flush=True)

    # --- the test fold from the pool and from host batches, on the best checkpoint
    cfg = compose(*train_cli.parse_cli(["model=ast", *common]))
    dm = train_cli.build_datamodule(cfg)
    from_pool = trainer.test(dm, state=trainer.state, ckpt=best)
    host = Trainer(**cfg.trainer.to_dict(), enable_checkpointing=False, device_data=False,
                   seed=seed)
    from_host = host.test(dm, state=trainer.state, ckpt=best)
    require(not host._use_device_data, "the host-streamed test used the pool")
    loss_rel = abs(from_host["test/loss"] - from_pool["test/loss"]) / abs(from_pool["test/loss"])
    require(np.array_equal(from_pool["confmat"], from_host["confmat"])
            and loss_rel <= TEST_LOSS_REL,
            f"pool vs host test: loss {from_pool['test/loss']} vs {from_host['test/loss']}")

    # --- evaluate on the best checkpoint ---------------------------------------
    ev = evaluate.main(["model=ast", *common, f"+ckpt_path={best}"])
    ev_rel = abs(ev["test/loss"] - res["test/loss"]) / abs(res["test/loss"])
    require(np.array_equal(ev["confmat"], res["confmat"]) and ev_rel <= TEST_LOSS_REL,
            f"evaluate: loss {ev['test/loss']} vs the train run's {res['test/loss']}")
    print(f"trainer: test from the pool and from host batches agree (loss rel {loss_rel:.2e}, "
          f"confusion matrices equal); evaluate +ckpt_path=best agrees with the train run's "
          f"test (loss rel {ev_rel:.2e})", flush=True)

    # --- predict: checkpoint mode and an exported artifact ----------------------
    rng = np.random.default_rng(seed + 18)
    files = []
    for seconds, label in ((5, 3), (12, 17), (2, 41)):
        p = tmp / f"clip_{seconds}s.wav"
        W.write_wav(p, synth_clip(rng, label, seconds * 44_100), 44_100)
        files.append(str(p))
    files_arg = "+files=[" + ",".join(files) + "]"
    by_ckpt = predict.main(["model=ast", *common, f"+ckpt_path={best}", files_arg])
    art = export.main(["model=ast", f"+ckpt_path={best}", f"+out={tmp / 'art'}",
                       "+dtype=bfloat16", f"+batch={SERVE_BATCH}", f"+clip_samples={CLIP}"])
    by_art = predict.main([f"+artifact={art}", files_arg])
    diffs = []
    for a, b in zip(by_ckpt, by_art, strict=True):
        pa, pb = dict(a["top_k"]), dict(b["top_k"])
        diffs.append(max(abs(pa[c] - pb[c]) for c in pa.keys() & pb.keys()))
        require(a["top_k"][0][0] == b["top_k"][0][0] and diffs[-1] <= PREDICT_PROB_ERR,
                f"predict modes disagree on {a['file']}: {a['top_k']} vs {b['top_k']}")
    print(f"trainer: predict top-1 by checkpoint {[r['top_k'][0] for r in by_ckpt]}, by "
          f"artifact {[r['top_k'][0] for r in by_art]}; top-1 margins "
          f"{[round(r['top_k'][0][1] - r['top_k'][1][1], 6) for r in by_ckpt]}, largest "
          f"probability difference per file {[f'{d:.2e}' for d in diffs]}", flush=True)

    # --- resume from 'last' for one more epoch -----------------------------------
    step0 = torch.load(last / "state.pt", map_location="cpu", weights_only=True)["step"]
    again = train_cli.main(["model=ast", *common, f"trainer.max_epochs={TRAINER_EPOCHS + 1}",
                            "+trainer.auto_resume=true"])
    resumed = again.pop("trainer")
    step1 = torch.load(last / "state.pt", map_location="cpu", weights_only=True)["step"]
    require(step0 == steps and [h["epoch"] for h in resumed.history] == [TRAINER_EPOCHS]
            and step1 == steps + shapes["steps"],
            f"resume: step {step0} → {step1}, epochs {[h['epoch'] for h in resumed.history]}")
    print(f"trainer: auto_resume from 'last' at step {step0} ran epoch {TRAINER_EPOCHS} "
          f"to step {step1}  [{card}]", flush=True)
    return counts

# --- phases 19-23: EnvNet-v2, the spectrogram CNN and LEAF ----------------------------

FAMILIES = bench.FAMILIES     # ("envnet_v2", "cnn_esc50", "leaf"), f32 with BatchNorm
FAMILY_NAMES = {"envnet_v2": "EnvNet-v2", "cnn_esc50": "CNN", "leaf": "LEAF"}
FAMILY_FWD_ERR = 1e-4   # card f32 (TF32 off) vs CPU f32, normalised by max |ref|: the
                        # convolution algorithms' summation orders only
FAMILY_HOLD_BATCH = {"envnet_v2": 4, "cnn_esc50": 8, "leaf": 2}
# Phase 21's batches, and LEAF's window: its step on the card machine's CPU took 253 s
# at 5 s and batch 8 (the Gabor conv), and its MLP BatchNorms over B rows need B well
# above 2 (over 2 rows each normalised value is ±1, and the gradient through them is
# ill-conditioned: 10% card vs CPU at batch 2)
FAMILY_PARITY_BATCH = {"envnet_v2": 4, "cnn_esc50": 4, "leaf": 8}
LEAF_PARITY_WINDOW = 0.25   # seconds: 11 025 samples, full widths (128 filters x 401)
FAMILY_STEP_LOSS = 1e-4  # one f32 step, card vs CPU, the same draws and choices: loss
                         # relative; gradients, parameters and BatchNorm statistics
                         # normalised per tensor (summation order; the CNN's K1 vs the
                         # plain mel). LEAF: 1e-3, its f32 floor (the CPU's own f32
                         # step is 1.7e-4 from an f64 step at this size, measured)
FAMILY_STEP_TOL = {"envnet_v2": 1e-4, "cnn_esc50": 1e-4, "leaf": 1e-3}
ENVNET_CLI_EPOCHS = 2


class BiasTerms:
    """The size of the terms of each pre-BatchNorm bias's gradient in one
    run. A bias b that feeds a BatchNorm in train mode has no effect on its
    output, so its gradient, sum over (n, h, w) of delta = dL/dz (z the
    BatchNorm's input), is 0 in exact arithmetic and only rounding noise in
    practice: divided by its own max |ref| its error is ~1 on any two
    correct runs. Its error is read against max_c sum |delta_c| instead, the
    size of the sum's terms, taken by a tensor hook on each BatchNorm's
    input; ``scales`` names the biases (found through z's autograd node)."""

    def __init__(self, model: torch.nn.Module):
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.scales: dict[str, float] = {}
        self.hooks = [m.register_forward_pre_hook(self._forward) for m in model.modules()
                      if isinstance(m, BatchNorm)]

    @staticmethod
    def _bias(fn, channels: int, depth: int = 3):
        """The 1-D parameter of ``channels`` entries nearest ``fn`` among its
        inputs, breadth first (the layer's own bias before an earlier
        layer's BatchNorm scale)."""
        level = [fn]
        for _ in range(depth):
            level = [nxt for f in level if f is not None for nxt, _ in f.next_functions]
            for nxt in level:
                var = getattr(nxt, "variable", None)
                if var is not None and var.ndim == 1 and var.numel() == channels:
                    return var
        return None

    def _forward(self, module, args):
        z = args[0]
        bias = self._bias(z.grad_fn, z.shape[1]) if z.requires_grad else None
        if bias is not None:
            name = self.names[id(bias)]
            dims = [0, *range(2, z.ndim)]
            z.register_hook(lambda g: self.scales.__setitem__(
                name, g.abs().sum(dims).max().item()))

    def remove(self) -> None:
        for h in self.hooks:
            h.remove()


class ChoiceLog:
    """The discrete choices of one run, replayed in call order in another,
    as ``RouteLog`` replays routes: each max pool's argmax (``F.max_pool1d``,
    ``F.max_pool2d``) and each ReLU's sign (``F.relu``). Either flips under a
    perturbation as small as a change of summation order wherever two
    inputs of a window nearly tie or an input is near 0, and a flip moves or
    drops a whole gradient term (a flipped hidden unit of EnvNet-v2's 4096-
    wide layers alone shifts the trunk's gradients by ~1e-3). Under
    ``record()`` the ops run as they are and their choices are kept; under
    ``replay()`` each pool takes its input at the recorded indices and each
    ReLU keeps the recorded positive set (so the gradient takes the recorded
    paths), and the choices that the replaying run would have made
    otherwise are counted (``flips`` of ``choices``)."""

    def __init__(self):
        self.choices: list[torch.Tensor] = []
        self.flips = self.total = 0

    @contextlib.contextmanager
    def _patched(self, pool, relu):
        saved = F.max_pool1d, F.max_pool2d, F.relu
        F.max_pool1d = functools.partial(pool, saved[0])
        F.max_pool2d = functools.partial(pool, saved[1])
        F.relu = relu
        try:
            yield self
        finally:
            F.max_pool1d, F.max_pool2d, F.relu = saved

    def record(self):
        def pool(orig, x, *args, **kw):
            out, idx = orig(x, *args, **kw, return_indices=True)
            self.choices.append(idx)
            return out

        def relu(x, inplace=False):
            self.choices.append(x.detach() > 0)
            return torch.relu(x)
        return self._patched(pool, relu)

    def _take(self, own: torch.Tensor, device: torch.device) -> torch.Tensor:
        recorded = self.choices[self.calls].to(device)
        self.calls += 1
        self.flips += int((own != recorded).sum())
        self.total += recorded.numel()
        return recorded

    def replay(self):
        self.calls = 0

        def pool(orig, x, *args, **kw):
            with torch.no_grad():
                own = orig(x, *args, **kw, return_indices=True)[1]
            idx = self._take(own, x.device)
            return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

        def relu(x, inplace=False):
            keep = self._take(x.detach() > 0, x.device)
            return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
        return self._patched(pool, relu)


@contextlib.contextmanager
def cudnn_tf32(on: bool):
    """cuDNN convolutions in TF32 (PyTorch's default, on) or in f32 (off)."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


@contextlib.contextmanager
def no_family_dropout(model: torch.nn.Module):
    """Dropout off in ``model`` (a check's patch, as the CPU tests set Flax's
    rate to 0): the card's and the CPU's generators draw different masks
    from one seed. EnvNet-v2's rate is the model's, the CNN's and LEAF's
    their modules' constants."""
    saved = cnn_esc50.DROPOUT, leaf.DROPOUT, getattr(model, "rate", None)
    cnn_esc50.DROPOUT = leaf.DROPOUT = 0.0
    if saved[2] is not None:
        model.rate = 0.0
    try:
        yield
    finally:
        cnn_esc50.DROPOUT, leaf.DROPOUT = saved[:2]
        if saved[2] is not None:
            model.rate = saved[2]


def _bn_stats(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {k: b.detach().clone() for k, b in model.named_buffers() if "running" in k}


def _family_clips(name: str, batch: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed + 19 + FAMILIES.index(name))
    return torch.from_numpy((rng.standard_normal((batch, CLIP)) * 0.3).astype(np.float32))


def phase_families_vs_cpu(dev: torch.device, seed: int, card: str) -> dict:
    """Phase 19: each family at full width, seeded weights and randomised
    BatchNorm statistics, in eval mode: the card's forward (f32, TF32 off)
    against the CPU's f32 forward on the same inputs (the CPU pipeline's),
    within ``FAMILY_FWD_ERR``; the error with cuDNN's TF32 on (PyTorch's
    default) is printed beside it."""
    out = {}
    for name in FAMILIES:
        model = bench.build_model(name, seed, torch.device("cpu"))
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.running_mean.normal_(0.0, 0.1, generator=g)
                    m.running_var.uniform_(0.5, 2.0, generator=g)
        x = bench.family_pipeline(name).eval_batch(_family_clips(name, FAMILY_HOLD_BATCH[name],
                                                                 seed))
        t0 = time.perf_counter()
        with torch.no_grad():
            want = model(x)
            cpu_s = time.perf_counter() - t0
            on_card = copy.deepcopy(model).to(dev)
            xd = x.to(dev)
            with cudnn_tf32(False):
                got = on_card(xd).cpu()
            with cudnn_tf32(True):
                got_tf32 = on_card(xd).cpu()
        e, e_tf32 = norm_err(got, want), norm_err(got_tf32, want)
        out[name] = dict(err=e, err_tf32=e_tf32)
        print(f"{FAMILY_NAMES[name]} eval forward, input {tuple(x.shape)}, card vs CPU f32: "
              f"TF32 off {e:.3e} (<= {FAMILY_FWD_ERR}), cuDNN TF32 on (PyTorch's default) "
              f"{e_tf32:.3e} [printed]; CPU forward {cpu_s:.2f} s  [{card}]", flush=True)
        require(torch.isfinite(got).all().item() and got.shape == want.shape
                and e <= FAMILY_FWD_ERR, f"{name}: the card's f32 forward disagrees with the CPU's")
        del model, on_card
        torch.cuda.empty_cache()
    return out


def phase_family_train(dev: torch.device, seed: int, card: str) -> tuple[dict, dict]:
    """Phase 20: each family's train step at batch 64 through
    ``scripts/bench.py``'s functions (f32, the configs' pipelines, EnvNet-v2
    with BC mixing and KLDiv), cuDNN at PyTorch's default (TF32 on): 2
    warm-up and 10 timed steps, then two profiled. Every loss finite, every
    parameter and every BatchNorm statistic changed; K1 once a CNN step and
    never in the others. Returns (launch counts, records) by family."""
    n = WARMUP_STEPS + TIMED_STEPS
    counts, recs = {}, {}
    for name in FAMILIES:
        step, state, ms, wave, labels = bench.build(TRAIN_BATCH, seed, dev, name)
        before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
        bn_before = _bn_stats(state.model)
        torch.cuda.reset_peak_memory_stats(dev)
        with cudnn_tf32(True):
            # --- the main path: only these launches are counted -----------------
            _reset_launches()
            state, ms, losses, step_s = bench.timed_steps(step, state, ms, wave, labels,
                                                          WARMUP_STEPS, TIMED_STEPS)
            counts[name] = _launch_counts()
            # ----------------------------------------------------------------------
            peak_mem = torch.cuda.max_memory_allocated(dev) / 2**30
            prof = bench.profile_steps(step, state, ms, wave, labels)
        rec = recs[name] = bench.record(state.model, TRAIN_BATCH, step_s, losses, peak_mem, prof)
        unchanged = [k for k, p in state.model.named_parameters() if torch.equal(before[k], p)]
        bn_after = _bn_stats(state.model)
        bn_same = [k for k in bn_before if torch.equal(bn_before[k], bn_after[k])]
        kinds = {k: round(v, 2) for k, v in prof["by_kind_ms"].items()}
        print(f"train: {FAMILY_NAMES[name]} f32 (cuDNN TF32 on), batch {TRAIN_BATCH}, "
              f"{WARMUP_STEPS} warm-up + {TIMED_STEPS} timed steps: {rec['step_ms']:.3f} ms/step, "
              f"{rec['value']:.2f} clips/s, peak memory {peak_mem:.2f} GiB; losses "
              f"{losses[0]:.4f} .. {losses[-1]:.4f}; launches {counts[name]}; profiled: busy "
              f"share {prof['busy_share']:.3f}, {prof['device_ms_per_step']:.1f} ms device time "
              f"per step, by kind {kinds}  [{card}]", flush=True)
        print(json.dumps(rec), flush=True)
        require(not unchanged, f"{name} parameters that did not change: {unchanged[:8]}")
        require(not bn_same, f"{name} BatchNorm statistics that did not change: {bn_same[:8]}")
        require(counts[name] == _counts(k1=n if name == "cnn_esc50" else 0,
                                        drop=FAMILY_DRAWS[name] * n),
                f"{name} launch counts {counts[name]} over {n} steps")
        del step, state, ms, wave, labels, before
        torch.cuda.empty_cache()
    return counts, recs


def phase_family_parity(dev: torch.device, seed: int) -> None:
    """Phase 21: one f32 train step of each family on the card (TF32 off)
    against the same step on the CPU: the same weights, clips and draws,
    dropout off (``no_family_dropout``), SGD with momentum and no clip (the
    momentum buffer after one step is the gradient); the loss, the
    gradients, the parameters after the update and the BatchNorm statistics
    within ``FAMILY_STEP_*`` (LEAF on a 0.25-s window, ``LEAF_PARITY_WINDOW``).
    A pre-BatchNorm bias's gradient, 0 in exact arithmetic, is read against
    the size of its terms (``BiasTerms``, the
    CPU run's), and its value after the update against lr x that size. The
    CPU run replays the card run's max-pool and ReLU choices
    (``ChoiceLog``); the choices that would flip are counted and printed."""
    lr = 1e-3
    for name in FAMILIES:
        batch, tol = FAMILY_PARITY_BATCH[name], FAMILY_STEP_TOL[name]
        pipe = bench.family_pipeline(name)
        if name == "leaf":
            pipe = DevicePipeline(dataclasses.replace(pipe.cfg, window_length=LEAF_PARITY_WINDOW))
        rng = np.random.default_rng(seed + 21)
        wave = _family_clips(name, batch, seed + 21)
        labels = torch.from_numpy(rng.permutation(AST_BASE["num_classes"])[:batch])
        draws = pipe.draw(batch, CLIP, rng)
        criterion = KLDivLoss() if name == "envnet_v2" else CrossEntropyLoss()

        def one_step(device, pools):
            model = bench.build_model(name, seed, device)
            state = TrainState.create(model, sgd(lr=lr, momentum=0.9), None, 25)
            step = make_train_step(pipe, criterion)
            terms = BiasTerms(model)
            _reset_launches()
            with no_family_dropout(model), pools:
                _, _, loss = step(state, MetricState.create(AST_BASE["num_classes"], device),
                                  wave.to(device), labels.to(device), draws, 0)
            terms.remove()
            names, params = zip(*model.named_parameters())
            return (loss.item(),
                    [state.optimizer.state[p]["momentum_buffer"].cpu() for p in params],
                    [p.detach().cpu() for p in params], _launch_counts(), names,
                    {k: b.cpu() for k, b in _bn_stats(model).items()}, terms.scales)

        log = ChoiceLog()
        with cudnn_tf32(False):
            card_run = one_step(dev, log.record())
            cpu = one_step(torch.device("cpu"), log.replay())
        print(f"{FAMILY_NAMES[name]}: the CPU run takes the card run's max-pool and ReLU "
              f"choices (ChoiceLog); its own differ in {log.flips} of {log.total}", flush=True)
        require(card_run[3] == _counts(k1=1 if name == "cnn_esc50" else 0),
                f"{name} parity launches {card_run[3]}")
        scales = cpu[6]
        require(len(scales) == len(cpu[5]) // 2,   # a mean and a var per BatchNorm
                f"{name}: a BatchNorm without its bias found, {sorted(scales)}")
        clip = f"{LEAF_PARITY_WINDOW}-s window" if name == "leaf" else "5-s clips"
        _compare_steps(card_run, cpu, f"{FAMILY_NAMES[name]} f32 card (TF32 off) vs CPU, "
                       f"{clip}, dropout off",
                       FAMILY_STEP_LOSS, tol, batch=batch,
                       scales=scales, param_scales={k: lr * v for k, v in scales.items()},
                       scaled="pre-BatchNorm biases, max |diff| / max_c sum |dL/dz_c|")
        e_bn = max(norm_err(card_run[5][k], cpu[5][k]) for k in cpu[5])
        print(f"  BatchNorm running statistics after the step, normalised per tensor: "
              f"{e_bn:.3e} (<= {tol})", flush=True)
        require(e_bn <= tol, f"{name} BatchNorm statistics, card vs CPU")
        del cpu, card_run
        torch.cuda.empty_cache()


def phase_family_serving(dev: torch.device, seed: int, tmp: Path, card: str) -> tuple[dict, list]:
    """Phase 22: each family exported by ``scripts/export.py`` (f32, seeded
    weights), loaded on the card and serving one batch of 8 (K1 once for
    the CNN, never for the others; the BatchNorm counters reloaded as
    int64); EnvNet-v2 exported with ``multi_crop_test`` and served over
    HTTP to 8 concurrent requests (ten crops each); then every row of
    ``scripts/bench_infer.py``. cuDNN at PyTorch's default (TF32 on).
    Returns (serving launch counts by family, the bench rows)."""
    from dlsc_tpu_torch.scripts import export

    counts = {}
    rng = np.random.default_rng(seed + 22)
    clips = (rng.standard_normal((SERVE_BATCH, CLIP)) * 0.1).astype(np.float32)
    with cudnn_tf32(True):
        for name in FAMILIES:
            art = export.main([f"model={name}", f"+out={tmp / name}", "+dtype=float32",
                               f"+seed={seed}", f"+batch={SERVE_BATCH}"])
            serve = load_exported(art, device="cuda")
            tracked = {b.dtype for k, b in serve.model.named_buffers()
                       if k.endswith("num_batches_tracked")}
            serve(clips)   # warm-up
            # --- the main path (serving): only these launches are counted ------
            _reset_launches()
            probs = serve(clips)
            torch.cuda.synchronize()
            counts[name] = _launch_counts()
            # ----------------------------------------------------------------------
            print(f"{FAMILY_NAMES[name]} exported by the CLI and served one batch of "
                  f"{SERVE_BATCH}: launches {counts[name]}; num_batches_tracked {tracked}",
                  flush=True)
            require(probs.shape == (SERVE_BATCH, AST_BASE["num_classes"])
                    and np.isfinite(probs).all()
                    and np.abs(probs.sum(-1) - 1.0).max() <= PROB_SUM_ERR,
                    f"{name} probabilities not finite, misshaped or not summing to 1")
            require(counts[name] == _counts(k1=1 if name == "cnn_esc50" else 0),
                    f"{name} serving launch counts {counts[name]}")
            require(tracked == {torch.int64}, f"{name} reloaded counters {tracked}")
            del serve
            torch.cuda.empty_cache()

        art = export.main(["model=envnet_v2", f"+out={tmp / 'envnet_10crop'}", "+dtype=float32",
                           f"+seed={seed}", f"+batch={SERVE_BATCH}",
                           "+model.dataset_overrides.preprocessing_config.multi_crop_test=true"])
        server = ModelServer(art, device="cuda", window_ms=20.0)
        require(server.manifest["pipeline_kwargs"]["multi_crop_test"], "10-crop artifact")
        httpd = server.make_http_server("127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            bodies = [("/predict_raw", json.dumps({"pcm": c.tolist(),
                                                   "sample_rate": 44_100}).encode())
                      for c in clips]
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(len(bodies)) as ex:
                answers = list(ex.map(lambda pb: _post(httpd.server_address[1], *pb), bodies))
            t_burst = time.perf_counter() - t0
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
        sums = [float(_check_probs(st, r, f"EnvNet 10-crop request {i}").sum())
                for i, (st, r) in enumerate(answers)]
        print(f"EnvNet-v2 10-crop artifact over HTTP: {len(answers)} requests in {t_burst:.3f} s, "
              f"{server.batcher.batches} device batches; probability sums "
              f"{min(sums):.6f} .. {max(sums):.6f} (1 ± {PROB_SUM_ERR})", flush=True)
        del server
        torch.cuda.empty_cache()

        rows = []
        t0 = time.perf_counter()
        for name, (_, batch, *_) in bench_infer.ROWS.items():
            # batch-1 rows at phase 4's 100 calls (p90 has 10 beyond it), not 1000;
            # the others at SERVING_ROW_CALLS
            rows.append(bench_infer.run_row(name, dev, calls=LATENCY_SAMPLES if batch == 1
                                            else SERVING_ROW_CALLS))
            print(json.dumps({**rows[-1], "card": card}), flush=True)
            torch.cuda.empty_cache()
        print(f"bench_infer: {len(rows)} rows in {time.perf_counter() - t0:.1f} s", flush=True)
        over = [(r["variant"], r["device_ms"], r["latency_ms"]) for r in rows
                if not r["device_ms"] <= r["latency_ms"]]
        print("bench_infer device ms (graph replay) / median latency ms: " + ", ".join(
            f"{r['variant']} {r['device_ms']:.3f}/{r['latency_ms']:.3f}" for r in rows),
            flush=True)
        require(not over, f"bench_infer rows whose device time passes their latency: {over}")
        _hold_int8_rows(dev)
    return counts, rows


def _hold_int8_rows(dev: torch.device) -> None:
    """Each int8 row of ``bench_infer`` against the bf16 row of its model and
    batch on the row's clips: the model that ``run_row`` times
    (``bench_infer.build`` with the row's ``quant``) against the bf16 row's,
    built from the same seed, whose float weights it must share; sigmoid
    outputs within ``INT8_ERR``."""
    floats = {}
    for name, (which, batch, dtype, pipe_kwargs, *quant) in bench_infer.ROWS.items():
        if not quant:
            continue
        if which not in floats:
            floats[which] = bench_infer.build(which, dtype, pipe_kwargs, dev)
        model, pipe = floats[which]
        qmodel, _ = bench_infer.build(which, dtype, pipe_kwargs, dev, quant[0])
        qsd = qmodel.state_dict()
        require(all(torch.equal(v, qsd[k]) for k, v in model.state_dict().items()),
                f"{name}: the int8 row's float weights are not the bf16 row's")
        wave = (np.random.default_rng(0).standard_normal((batch, CLIP)) * 0.3).astype(np.float32)
        with torch.inference_mode():
            feats = pipe.eval_batch(torch.from_numpy(wave).to(dev))
            err = (qmodel(feats) - model(feats)).abs().max().item()
        print(f"{name} vs its bf16 row, sigmoid outputs: {err:.3e} (<= {INT8_ERR[quant[0]]})",
              flush=True)
        require(err <= INT8_ERR[quant[0]], f"{name} disagrees with its bf16 row")
        del qmodel
    del floats
    torch.cuda.empty_cache()


def phase_envnet_trainer(dev: torch.device, seed: int, tmp: Path, card: str) -> dict:
    """Phase 23: EnvNet-v2 through the train CLI on phase 18's shards (in
    ``tmp / 'data'``): f32, batch 64, BC mixing with ``KLDivLoss``, ten
    crops for validation and test, SWA from the second epoch (so the
    BatchNorm refresh runs), the best checkpoint only; then ``evaluate`` on
    that checkpoint, which must give the train run's test. cuDNN at
    PyTorch's default. Returns the train CLI's launch counts."""
    from dlsc_tpu_torch.scripts import evaluate
    from dlsc_tpu_torch.scripts import train as train_cli

    common = [f"dataset.root={tmp / 'data'}", "dataset.fold=0", "trainer.precision=32",
              f"batch_size={TRAIN_BATCH}", f"checkpoint.dirpath={tmp / 'envnet_ckpt'}",
              f"hydra.run.dir={tmp / 'envnet_run'}", f"seed={seed}",
              "loss._target_=torch.nn.KLDivLoss",
              "+model.dataset_overrides.preprocessing_config.multi_crop_test=true"]
    with cudnn_tf32(True):
        # --- the main path: only these launches are counted ---------------------
        _reset_launches()
        t0 = time.perf_counter()
        res = train_cli.main(["model=envnet_v2", *common,
                              f"trainer.max_epochs={ENVNET_CLI_EPOCHS}", "+swa.enabled=true",
                              "+swa.swa_epoch_start=1"])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        counts = _launch_counts()
        # --------------------------------------------------------------------------
        trainer = res.pop("trainer")
        hist = trainer.history
        best = trainer.ckpt_manager.best_path
        writes = trainer.ckpt_manager.write_seconds
        require([h["epoch"] for h in hist] == list(range(ENVNET_CLI_EPOCHS))
                and all(np.isfinite(h["train/loss"]) and "val/acc" in h for h in hist),
                f"EnvNet trainer epochs {hist}")
        require(best.is_dir() and not (best.parent / "last").exists() and 1 <= len(writes) <= 3,
                f"EnvNet checkpoints: best {best}, {len(writes)} writes")
        require(all(np.isfinite(res[k]) for k in ("test/acc", "test/f1", "test/auroc",
                                                  "test/loss")), f"EnvNet test {res}")
        # the fit's steps and SWA's BatchNorm refresh draw dropout (train mode)
        require(counts == _counts(drop=counts["drop"]) and counts["drop"] > 0,
                f"EnvNet trainer launches {counts}")
        t0 = time.perf_counter()
        ev = evaluate.main(["model=envnet_v2", *common, f"+ckpt_path={best}"])
        ev_s = time.perf_counter() - t0
    ev_rel = abs(ev["test/loss"] - res["test/loss"]) / abs(res["test/loss"])
    print(f"trainer: EnvNet-v2 f32 batch {TRAIN_BATCH}, BC mixing + KLDiv, 10-crop val/test, "
          f"SWA from epoch 1 with the BatchNorm refresh: fit {trainer.fit_seconds:.2f} s, train "
          f"CLI {main_s:.2f} s; epoch clips/s "
          f"{[round(h['perf/clips_per_sec_per_chip'], 2) for h in hist]}; train/loss "
          f"{[round(h['train/loss'], 4) for h in hist]}, val/acc "
          f"{[round(h['val/acc'], 4) for h in hist]}; test acc {res['test/acc']:.4f} F1 "
          f"{res['test/f1']:.4f} AUROC {res['test/auroc']:.4f} loss {res['test/loss']:.4f}; "
          f"checkpoint writes {len(writes)} x {_dir_mb(best):.0f} MB in "
          f"{', '.join(f'{t:.2f}' for t in writes)} s; evaluate on the best checkpoint "
          f"{ev_s:.2f} s: loss rel {ev_rel:.2e}, confusion matrices equal: "
          f"{np.array_equal(ev['confmat'], res['confmat'])}  [{card}]", flush=True)
    require(np.array_equal(ev["confmat"], res["confmat"]) and ev_rel <= TEST_LOSS_REL,
            f"EnvNet evaluate: loss {ev['test/loss']} vs the train run's {res['test/loss']}")
    return counts


REMAT_RUN = ("full", "dots", "attn_out", "attn_res", "attn_res_qkv", "attn_res_fc1")
REMAT_RERUN_K2F = ("full", "dots", "attn_out")   # K2f twice a block: its outputs not kept
REMAT_F32_BATCH = 4
REMAT_GRAD_ERR = 1e-5   # the same kernels rerun on the same inputs: near-bitwise
REMAT_WARMUP, REMAT_STEPS = 1, 3
INT8_ERR = {"w8a8": 0.05, "w8": 0.06}   # tests/test_quant.py's bars, sigmoid outputs
DEIT_GRID = 24          # deit_base_patch16_384: 384 / 16 patches a side


def _grads(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def _grad_err(got: dict, want: dict) -> tuple[float, str]:
    """The largest max-normalised gradient error and its parameter."""
    return max((norm_err(got[k], want[k]), k) for k in want if want[k].abs().max() > 0)


def phase_remat(dev: torch.device, seed: int, card: str) -> dict:
    """Phase 24: AST-Base (768/12/12, 1645 → 1664 tokens) under each remat
    policy but ``attn_res_moe``: one f32 forward and backward through the
    kernels at batch 4 on the same features, gradients against ``full``'s
    (``REMAT_GRAD_ERR``), K2f 24 under ``full``, ``dots`` and ``attn_out``
    and 12 under the ``attn_res*`` policies, K2b 12; then the bench's bf16
    batch-64 train step under the policy (1 warm-up + 3 timed steps): ms,
    clips/s, peak GiB and launches a step. Then AST-MoE at batch 64 (bf16,
    dropout 0.1 with one seed) under ``attn_res_moe`` and ``attn_res`` on the
    same routes (``RouteLog``): gradients equal within ``REMAT_GRAD_ERR``,
    gmm 48 against 72 launches (no gmm re-forward), tgmm 24 both; and each
    one's bench step. Returns the launch counts of every step run."""
    rng = np.random.default_rng(seed + 24)
    pipe = DevicePipeline(PipelineConfig(mode="ast", num_classes=AST_BASE["num_classes"]))
    wave = torch.from_numpy((rng.standard_normal((TRAIN_BATCH, CLIP)) * 0.3)
                            .astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, AST_BASE["num_classes"], TRAIN_BATCH)).to(dev)
    feats = pipe.eval_batch(wave[:REMAT_F32_BATCH])
    total = collections.Counter()
    want = None
    for policy in REMAT_RUN:
        model = ASTModel(**AST_BASE, dtype=torch.float32, remat=True, remat_policy=policy,
                         device=dev, generator=torch.Generator().manual_seed(seed)).train()
        # --- a main path (remat f32 step): only these launches are counted -----
        _reset_launches()
        F.cross_entropy(model(feats), labels[:REMAT_F32_BATCH]).backward()
        torch.cuda.synchronize()
        counts = _launch_counts()
        # ----------------------------------------------------------------------------
        total.update(counts)
        grads = _grads(model)
        del model
        want = want or grads
        err, worst = _grad_err(grads, want)
        k2f = 2 * DEPTH if policy in REMAT_RERUN_K2F else DEPTH
        print(f"remat {policy}: f32 batch {REMAT_F32_BATCH}: gradients vs full {err:.3e} "
              f"(largest: {worst}; <= {REMAT_GRAD_ERR}); launches {counts}", flush=True)
        require(err <= REMAT_GRAD_ERR, f"remat {policy} gradients differ from full's")
        require(counts == _counts(k2f=k2f, k2b=DEPTH), f"remat {policy} launches {counts}")
    del want, grads
    torch.cuda.empty_cache()

    for model_name, policies in (("ast", REMAT_RUN), ("ast_moe", ("attn_res", "attn_res_moe"))):
        for policy in policies:
            step, state, ms, w, lab = bench.build(TRAIN_BATCH, seed, dev, model_name,
                                                  remat_policy=policy)
            torch.cuda.reset_peak_memory_stats(dev)
            # --- a main path (remat bf16 train steps): only these are counted ------
            _reset_launches()
            state, ms, losses, step_s = bench.timed_steps(step, state, ms, w, lab,
                                                          REMAT_WARMUP, REMAT_STEPS)
            counts = _launch_counts()
            # --------------------------------------------------------------------------
            total.update(counts)
            n = REMAT_WARMUP + REMAT_STEPS
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            per_step = {k: v / n for k, v in counts.items() if v}
            print(f"remat {policy}: {'AST-Base' if model_name == 'ast' else 'AST-MoE'} bf16 "
                  f"batch {TRAIN_BATCH} train step {step_s * 1e3:.2f} ms, "
                  f"{TRAIN_BATCH / step_s:.2f} clips/s, peak {peak:.2f} GiB; launches a step "
                  f"{per_step}; losses {losses[0]:.4f} .. {losses[-1]:.4f}  [{card}]",
                  flush=True)
            if model_name == "ast":
                k2f = 2 * DEPTH if policy in REMAT_RERUN_K2F else DEPTH
                require(counts == _counts(k1=n, k2f=k2f * n, k2b=DEPTH * n),
                        f"remat {policy} bench launches {counts}")
            del step, state, ms
            torch.cuda.empty_cache()

    # --- AST-MoE: attn_res_moe against attn_res on the same routes --------------
    feats = pipe.eval_batch(wave)
    log, runs = RouteLog(), {}
    for policy in ("attn_res_moe", "attn_res"):
        model = ASTMoE(**AST_MOE, remat=True, remat_policy=policy, device=dev,
                       generator=torch.Generator().manual_seed(seed)).train()
        topk = log.record if not log.routes else log.replay(len(log.routes))
        # --- a main path (AST-MoE remat step): only these launches are counted ----
        _reset_launches()
        out, aux, _ = model(feats, topk=topk, dropout_seed=seed, return_aux=True)
        (F.cross_entropy(out, labels) + aux).backward()
        torch.cuda.synchronize()
        counts = _launch_counts()
        # ------------------------------------------------------------------------------
        total.update(counts)
        runs[policy] = (_grads(model), counts)
        del model, out, aux
    err, worst = _grad_err(runs["attn_res_moe"][0], runs["attn_res"][0])
    c_moe, c_res = runs["attn_res_moe"][1], runs["attn_res"][1]
    print(f"remat attn_res_moe vs attn_res, AST-MoE bf16 batch {TRAIN_BATCH}, dropout 0.1, the "
          f"same routes: gradients {err:.3e} (largest: {worst}; <= {REMAT_GRAD_ERR}); "
          f"launches {c_moe} vs {c_res}", flush=True)
    require(err <= REMAT_GRAD_ERR, "attn_res_moe gradients differ from attn_res's")
    moe_depth = DEPTH
    # both policies rerun the draw (neither keeps a dropout's output)
    require(c_moe == _counts(k2f=moe_depth, k2b=moe_depth, gmm=4 * moe_depth, tgmm=2 * moe_depth,
                             drop=_draws(moe_depth, True))
            and c_res == _counts(k2f=moe_depth, k2b=moe_depth, gmm=6 * moe_depth,
                                 tgmm=2 * moe_depth, drop=_draws(moe_depth, True)),
            f"AST-MoE remat launches {c_moe} vs {c_res}")
    del runs
    torch.cuda.empty_cache()
    return dict(total)


def _deit_base_sd(seed: int) -> dict[str, torch.Tensor]:
    """A state dict with timm ``deit_base_patch16_384``'s keys and shapes
    (``tests/test_torch_import.py::_deit_base_sd``'s layout), N(0, 0.02)
    weights from ``seed``, the LayerNorm scales 1 + N(0, 0.02) so that the
    blocks pass a signal."""
    g = torch.Generator().manual_seed(seed)
    D = AST_BASE_WIDTH

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    sd = {"cls_token": r(1, 1, D), "pos_embed": r(1, 1 + DEIT_GRID ** 2, D),
          "patch_embed.proj.weight": r(D, 3, 16, 16), "patch_embed.proj.bias": r(D),
          "norm.weight": 1 + r(D), "norm.bias": r(D), "head.weight": r(1000, D),
          "head.bias": r(1000)}
    for i in range(DEPTH):
        b = f"blocks.{i}."
        sd.update({b + "norm1.weight": 1 + r(D), b + "norm1.bias": r(D),
                   b + "attn.qkv.weight": r(3 * D, D), b + "attn.qkv.bias": r(3 * D),
                   b + "attn.proj.weight": r(D, D), b + "attn.proj.bias": r(D),
                   b + "norm2.weight": 1 + r(D), b + "norm2.bias": r(D),
                   b + "mlp.fc1.weight": r(4 * D, D), b + "mlp.fc1.bias": r(4 * D),
                   b + "mlp.fc2.weight": r(D, 4 * D), b + "mlp.fc2.bias": r(D)})
    return sd


def _reference_ast(sd: dict, head_w: torch.Tensor, head_b: torch.Tensor, feats: torch.Tensor,
                   grid: tuple[int, int], antialias: bool = True) -> torch.Tensor:
    """The reference's AST recipe and forward (src/models/ast.py:30-63) on a
    timm state dict, in plain f32 torch ops: channel-mean patch conv with
    stride 10, CLS token, the 24 x 24 positional grid resized bilinearly
    (``antialias`` as the JAX package resizes; the reference's own
    ``F.interpolate`` does not antialias), 12 pre-LN blocks with softmax
    attention over the real tokens, final LN, sigmoid(head(CLS))."""
    D, H = AST_BASE_WIDTH, HEADS
    dh = D // H
    w = sd["patch_embed.proj.weight"].mean(1, keepdim=True)
    x = F.conv2d(feats[:, None], w, sd["patch_embed.proj.bias"], stride=10)
    x = x.flatten(2).transpose(1, 2)
    B, N, _ = x.shape
    pe = sd["pos_embed"]
    g = pe[:, 1:].reshape(1, DEIT_GRID, DEIT_GRID, D).permute(0, 3, 1, 2)
    g = F.interpolate(g, size=grid, mode="bilinear", align_corners=False, antialias=antialias)
    pos = torch.cat([pe[:, :1], g.permute(0, 2, 3, 1).reshape(1, -1, D)], dim=1)
    x = torch.cat([sd["cls_token"].expand(B, 1, D), x], dim=1) + pos[:, :N + 1]
    for i in range(DEPTH):
        b = f"blocks.{i}."
        h = F.layer_norm(x, (D,), sd[b + "norm1.weight"], sd[b + "norm1.bias"], 1e-6)
        qkv = F.linear(h, sd[b + "attn.qkv.weight"], sd[b + "attn.qkv.bias"])
        q, k, v = qkv.reshape(B, N + 1, 3, H, dh).permute(2, 0, 3, 1, 4)
        a = torch.softmax(q @ k.transpose(-1, -2) * dh ** -0.5, dim=-1) @ v
        x = x + F.linear(a.transpose(1, 2).reshape(B, N + 1, D), sd[b + "attn.proj.weight"],
                         sd[b + "attn.proj.bias"])
        h = F.layer_norm(x, (D,), sd[b + "norm2.weight"], sd[b + "norm2.bias"], 1e-6)
        h = F.gelu(F.linear(h, sd[b + "mlp.fc1.weight"], sd[b + "mlp.fc1.bias"]))
        x = x + F.linear(h, sd[b + "mlp.fc2.weight"], sd[b + "mlp.fc2.bias"])
    x = F.layer_norm(x[:, 0], (D,), sd["norm.weight"], sd["norm.bias"], 1e-6)
    return torch.sigmoid(F.linear(x, head_w, head_b))


def phase_import_int8(dev: torch.device, seed: int, tmp: Path, card: str) -> dict:
    """Phase 25: a seeded ``deit_base_patch16_384`` state dict written to a
    ``.pth`` → the port's ``import_vit`` (its ``--audit`` on the card, then
    the weights directory) → ``export model=ast +ckpt_path=`` three ways
    (bf16, ``+quant=w8``, ``+quant=w8a8``) → each loaded on the card and
    serving a batch of 8 synthetic clips (K1 1, K2f 12 a batch), held
    against the reference recipe's forward in plain f32 ops on the same
    features (the bf16 artifact within ``SLICE_BF16_ERR``, w8 and w8a8
    within ``INT8_ERR``); then the w8a8 artifact over HTTP to a burst; then
    ``torch._int_mm`` at fc1's batch-64 shape beside the bf16 GEMM. Returns
    the launch counts of the served batches and the burst."""
    from dlsc_tpu_torch.scripts import export, import_vit

    sd = _deit_base_sd(seed)
    pth = tmp / "deit_base_patch16_384.pth"
    torch.save({"model": sd, "epoch": 300}, pth)
    args = ["--checkpoint", str(pth), "--num-classes", str(AST_BASE["num_classes"])]
    t0 = time.perf_counter()
    require(import_vit.main([*args, "--out", str(tmp / "audit"), "--audit"]) is None
            and not (tmp / "audit").exists(), "import_vit --audit wrote weights")
    pretrained = import_vit.main([*args, "--out", str(tmp / "pretrained")])
    t_import = time.perf_counter() - t0
    common = ["model=ast", f"+ckpt_path={pretrained}", f"+batch={SERVE_BATCH}", f"+seed={seed}"]
    arts = {mode: export.main([*common, f"+out={tmp / f'ast_{mode or 'bf16'}'}",
                               *([f"+quant={mode}"] if mode else [])])
            for mode in (None, "w8", "w8a8")}
    print(f"import_vit (audit + weights) {t_import:.2f} s; exported bf16, w8 and w8a8 "
          f"artifacts from {pretrained}", flush=True)

    rng = np.random.default_rng(seed + 25)
    clips = (rng.standard_normal((SERVE_BATCH, CLIP)) * 0.1).astype(np.float32)
    total = collections.Counter()
    want = want_plain = None
    for mode, art in arts.items():
        serve = load_exported(art, device="cuda")
        require(serve.manifest.get("quant") == mode and serve.model.quant == mode,
                f"artifact {art} rebuilt in mode {serve.model.quant}")
        serve(clips)   # warm-up
        # --- a main path (imported weights served): only these are counted --------
        _reset_launches()
        probs = serve(clips)
        torch.cuda.synchronize()
        counts = _launch_counts()
        # ------------------------------------------------------------------------------
        total.update(counts)
        require(counts == _counts(k1=1, k2f=DEPTH), f"{mode} serving launches {counts}")
        require(probs.shape == (SERVE_BATCH, AST_BASE["num_classes"])
                and np.isfinite(probs).all() and np.abs(probs.sum(-1) - 1).max() <= PROB_SUM_ERR,
                f"{mode} probabilities")
        feats = serve.pipe.eval_batch(torch.from_numpy(clips).to(dev))
        with torch.inference_mode():
            got = serve.model(feats).float()
            if want is None:
                ref_sd = {k: v.to(dev) for k, v in sd.items()}
                head = serve.model.head
                want = _reference_ast(ref_sd, head.weight, head.bias, feats,
                                      serve.model.grid_size)
                want_plain = _reference_ast(ref_sd, head.weight, head.bias, feats,
                                            serve.model.grid_size, antialias=False)
                del ref_sd
        err = (got - want).abs().max().item()
        bar = INT8_ERR[mode] if mode else SLICE_BF16_ERR
        print(f"imported AST-Base served {mode or 'bf16'}: sigmoid outputs vs the reference "
              f"recipe in plain f32 ops {err:.3e} (<= {bar}); launches {counts}; outputs "
              f"{want.min().item():.4f} .. {want.max().item():.4f}", flush=True)
        require(err <= bar, f"imported {mode or 'bf16'} artifact disagrees with the reference")
        if mode == "w8a8":
            server = ModelServer(art, device="cuda", window_ms=20.0)
            httpd = server.make_http_server("127.0.0.1", 0)
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()
            try:
                bodies = [("/predict_raw", json.dumps({"pcm": c.tolist(),
                                                       "sample_rate": 44_100}).encode())
                          for c in np.concatenate([clips, clips])]
                _reset_launches()
                with concurrent.futures.ThreadPoolExecutor(len(bodies)) as ex:
                    answers = list(ex.map(lambda pb: _post(httpd.server_address[1], *pb),
                                          bodies))
                torch.cuda.synchronize()
                counts = _launch_counts()
            finally:
                httpd.shutdown()
                httpd.server_close()
                thread.join(timeout=30)
            total.update(counts)
            for i, (st, r) in enumerate(answers):
                _check_probs(st, r, f"w8a8 request {i}")
            batches = server.batcher.batches
            print(f"w8a8 artifact over HTTP: {len(answers)} requests, {batches} device batches, "
                  f"launches {counts}", flush=True)
            require(counts["k1"] >= 1 and counts["k2f"] == DEPTH * counts["k1"],
                    f"w8a8 HTTP launches {counts}")
            del server
        del serve
        torch.cuda.empty_cache()
    e_plain = (want_plain - want).abs().max().item()
    print(f"the reference recipe with F.interpolate's default (no antialias) vs with it, the "
          f"same weights: {e_plain:.3e}  [printed only: ROADMAP §3]", flush=True)

    # --- torch._int_mm at fc1's training-batch shape, beside the bf16 GEMM -------
    M_, K_, N_ = TRAIN_BATCH * N_PAD, AST_BASE_WIDTH, 4 * AST_BASE_WIDTH
    g = torch.Generator(device=dev).manual_seed(seed)
    xq = torch.randint(-127, 128, (M_, K_), generator=g, device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (N_, K_), generator=g, device=dev, dtype=torch.int8)
    xb, wb = xq.to(torch.bfloat16), wq.to(torch.bfloat16)
    int_ms, bf_ms = paired_ms(lambda: torch._int_mm(xq, wq.t()), lambda: xb @ wb.t())
    exact = torch.equal(torch._int_mm(xq[:4096], wq.t()),
                        (xq[:4096].double() @ wq.double().t()).to(torch.int32))
    ops = 2 * M_ * K_ * N_
    print(f"torch._int_mm at fc1's shape ({M_} x {K_} x {N_}, {ops / 1e12:.3f} TOP): "
          f"{int_ms:.4f} ms ({ops / int_ms / 1e9:.1f} TOP/s), exact {exact}; bf16 GEMM "
          f"{bf_ms:.4f} ms ({ops / bf_ms / 1e9:.1f} TFLOP/s)  [{card}]", flush=True)
    require(exact, "torch._int_mm disagrees with an exact product")
    return dict(total)


# --- phase 26: AST-MoE's capacity dispatches and expert-choice router -----------------

MOE_LOWERINGS = {("token", "einsum"): "ast_moe_einsum_train",
                 ("token", "scatter"): "ast_moe_scatter_train",
                 ("expert", "einsum"): "ast_moe_expert_train"}
LOWERING_ERR = 1e-5     # einsum vs scatter, plain f32 steps on the same routes: the same
                        # products, only the order of the K-term combine sum differs


def _capacity_step(dev: torch.device, seed: int, moe: dict, batch: int, dtype: torch.dtype,
                   plain: bool, topk=None, remat: bool = False):
    """One SGD step (momentum 0.9, clip 1.0, the bench's pipeline) of
    AST-MoE with ``moe``'s router and dispatch at ``batch``, dropout 0.1
    with one seed, the same draws for every call with the same ``seed``
    and ``batch``; ``plain`` runs plain attention. Returns (loss,
    gradients, parameters after the update, launch counts, names), as
    ``phase_moe_parity``'s steps."""
    pipe = bench.bench_pipeline()
    rng = np.random.default_rng(seed + 26)
    wave = torch.from_numpy((rng.standard_normal((batch, CLIP)) * 0.3)
                            .astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, AST_MOE["num_classes"], batch)).to(dev)
    draws = pipe.draw(batch, CLIP, rng)
    model = ASTMoE(**{**AST_MOE, **moe}, dtype=dtype, remat=remat, device=dev,
                   generator=torch.Generator().manual_seed(seed))
    state = TrainState.create(model, sgd(lr=5e-4, momentum=0.9), None, 25,
                              gradient_clip_val=1.0)
    step = make_train_step(pipe, CrossEntropyLoss(), **(dict(topk=topk) if topk else {}),
                           **(_plain_ops() if plain else {}))
    _reset_launches()
    _, _, loss = step(state, MetricState.create(AST_MOE["num_classes"], dev, MOE_METRICS),
                      wave, labels, draws, int(rng.integers(2**62)))
    torch.cuda.synchronize()
    names, params = zip(*model.named_parameters())
    grads = [state.optimizer.state[p]["momentum_buffer"] for p in params]
    return loss.item(), grads, [p.detach() for p in params], _launch_counts(), names


def phase_moe_lowerings(dev: torch.device, seed: int, card: str, ragged: dict) -> dict:
    """Phase 26: AST-MoE training on each capacity path of ``MOE_LOWERINGS``
    through ``scripts/bench.py``'s functions, beside phase 10's ragged
    record ``ragged``; then the parity checks of the module docstring.
    Returns each path's launch counts by its ``launches_by_path`` name."""
    n = WARMUP_STEPS + TIMED_STEPS
    runs, rows = {}, [("token", "ragged", ragged)]
    for (router, dispatch), path in MOE_LOWERINGS.items():
        moe = dict(router=router, dispatch=dispatch)
        step, state, ms, wave, labels = bench.build(TRAIN_BATCH, seed, dev, "ast_moe", moe=moe)
        routed = ExpertTokens(state.model, MOE_N_REAL)
        before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
        torch.cuda.reset_peak_memory_stats(dev)
        # --- a main path (the capacity path's train steps): only these are counted --
        _reset_launches()
        state, ms, losses, step_s = bench.timed_steps(step, state, ms, wave, labels,
                                                      WARMUP_STEPS, TIMED_STEPS)
        counts = _launch_counts()
        # ------------------------------------------------------------------------------
        runs[path] = counts
        peak_mem = torch.cuda.max_memory_allocated(dev) / 2**30
        named = dict(state.model.named_parameters())
        unchanged = [k for k, p in named.items() if torch.equal(before[k], p)]
        idle = routed.idle()
        experts = [(k, e) for k, p in named.items() if k.split(".")[-1] in ("wi", "bi", "wo", "bo")
                   for e in range(p.shape[0])
                   if (int(k.split(".")[1]), e) not in idle and torch.equal(before[k][e], p[e])]
        del before
        stats = {k: float(v) for k, v in ms.extra_means().items()}
        prof = bench.profile_steps(step, state, ms, wave, labels)
        rec = {**bench.record(state.model, TRAIN_BATCH, step_s, losses, peak_mem, prof), **stats}
        rows.append((router, dispatch, rec))
        print(json.dumps(rec), flush=True)
        print(f"AST-MoE {router}-choice, {dispatch} dispatch: (block, expert) without a kept "
              f"token that reaches the loss: {idle} ({len(idle)}); launches per step "
              f"{ {k: v / n for k, v in counts.items() if v} }", flush=True)
        require(not unchanged, f"{path}: parameters that did not change: {unchanged[:8]}")
        require(not experts, f"{path}: experts whose weights did not change: {experts[:8]}")
        require(counts == _counts(k1=n, k2f=DEPTH * n, k2b=DEPTH * n,
                                  drop=_draws(DEPTH, True) * n),
                f"{path} launch counts {counts} over {n} steps")
        del step, state, ms, named
        torch.cuda.empty_cache()
    spec = as_moe_spec({k: AST_MOE[k] for k in ("n_experts", "top_k", "capacity_factor",
                                                "group_size")})
    S, G, C = moe_capacity(spec, MOE_N_PAD, MOE_N_REAL)
    print(f"AST-MoE train step, bf16, remat attn_res, dropout 0.1, batch {TRAIN_BATCH}, "
          f"{WARMUP_STEPS} warm-up + {TIMED_STEPS} timed steps, {MOE_N_REAL} -> {MOE_N_PAD} "
          f"tokens; capacity paths in groups of S {S} (G {G}), C {C} slots an expert  [{card}]",
          flush=True)
    print("  router  dispatch  ms/step  clips/s  peak GiB  busy  drop_frac  util", flush=True)
    for router, dispatch, rec in rows:
        note = "  (phase 10)" if dispatch == "ragged" else ""
        print(f"  {router:6}  {dispatch:8}  {rec['step_ms']:.3f}  {rec['value']:.2f}  "
              f"{rec['peak_mem_gib']:.2f}  {rec['profile']['busy_share']:.3f}  "
              f"{rec.get('moe/drop_frac', 0.0):.4f}  {rec.get('moe/util', float('nan')):.4f}{note}",
              flush=True)

    # --- parity at batch 4: kernels vs plain ops, einsum vs scatter -------------------
    plain = {}
    for router, dispatch in MOE_LOWERINGS:
        moe = dict(router=router, dispatch=dispatch)
        log = RouteLog()
        k32 = _capacity_step(dev, seed, moe, PARITY_BATCH, torch.float32, False, log.record)
        p32 = plain[(router, dispatch)] = _capacity_step(
            dev, seed, moe, PARITY_BATCH, torch.float32, True, log.replay(DEPTH))
        if (router, dispatch) == ("token", "einsum"):
            einsum_routes = log
        d32 = _draws(DEPTH, False)
        require(k32[3] == _counts(k1=1, k2f=DEPTH, k2b=DEPTH, drop=d32)
                and p32[3] == _counts(k1=1, drop=d32),
                f"{router}/{dispatch} parity launches {k32[3]} {p32[3]}")
        _compare_steps(k32, p32, f"f32 kernels vs f32 plain attention, same routes (AST-MoE "
                       f"{router}-choice, {dispatch} dispatch, dropout 0.1", STEP_F32_LOSS,
                       STEP_F32_GRAD)
    scatter = _capacity_step(dev, seed, dict(router="token", dispatch="scatter"), PARITY_BATCH,
                             torch.float32, True, einsum_routes.replay(DEPTH))
    _compare_steps(scatter, plain[("token", "einsum")], "scatter vs einsum dispatch, f32 plain "
                   "ops, the einsum run's routes (AST-MoE token-choice, dropout 0.1",
                   LOWERING_ERR, LOWERING_ERR)
    del plain, scatter
    torch.cuda.empty_cache()

    # --- the scatter path's bf16 step, twice: its atomic adds change no sum -----------
    moe = dict(router="token", dispatch="scatter")
    first, second = (_capacity_step(dev, seed, moe, TRAIN_BATCH, torch.bfloat16, False,
                                    remat=True) for _ in range(2))
    same = first[0] == second[0] and all(torch.equal(a, b) for a, b in zip(first[1], second[1]))
    print(f"AST-MoE scatter dispatch, bf16 kernels, remat attn_res, batch {TRAIN_BATCH}: one "
          f"step run twice: loss {first[0]!r} vs {second[0]!r}, gradients of all "
          f"{len(first[1])} parameters bit-identical: {same}", flush=True)
    require(same, "the scatter dispatch's step is not bitwise reproducible")
    return runs


# --- phase 27: the HPO slice -----------------------------------------------------------

HPO_TRIALS, HPO_EPOCHS = 4, 2


def phase_hpo(dev: torch.device, seed: int, tmp: Path, card: str) -> dict:
    """Phase 27: an AST-MoE study through ``scripts/optimize_hyperparams.py``
    on phase 18's shards (``tmp / "data"``), per-trial readings from a study
    callback, then ``analyze_study`` and ``debug_optimize``. Returns the
    study's launch counts."""
    from dlsc_tpu_torch.hpo import TrialState
    from dlsc_tpu_torch.scripts import analyze_study, debug_optimize, optimize_hyperparams

    out, db = tmp / "hpo", tmp / "hpo" / "study.db"
    per_fold = TRAINER_CLASSES * TRAINER_CLIPS
    common = ["model=ast_moe", f"dataset.root={tmp / 'data'}", "dataset.fold=0",
              "trainer.precision=bf16-mixed", f"trainer.max_epochs={HPO_EPOCHS}", f"seed={seed}",
              f"optuna.storage_path=sqlite:///{db}", f"optuna.output_dir={out}",
              "optuna.study_name=ast_moe_card"]
    trials, last = [], {}

    def reading(study, trial):
        counts = _launch_counts()
        launches = {k: v - last.get(k, 0) for k, v in counts.items()}
        last.update(counts)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        torch.cuda.reset_peak_memory_stats(dev)
        trials.append((trial, launches, peak))
        print(f"hpo trial {trial.number}: {trial.state} value {trial.value} fit "
              f"{trial.user_attrs.get('fit_seconds', float('nan')):.2f} s, peak {peak:.2f} GiB, "
              f"launches { {k: v for k, v in launches.items() if v} }; params "
              f"{trial.params}  [{card}]", flush=True)

    torch.cuda.reset_peak_memory_stats(dev)
    # --- the main path: only these launches are counted ---------------------
    _reset_launches()
    t0 = time.perf_counter()
    study = optimize_hyperparams.main([*common, f"optuna.n_trials={HPO_TRIALS}"],
                                      callbacks=[reading])
    torch.cuda.synchronize()
    study_s = time.perf_counter() - t0
    counts = _launch_counts()
    # --------------------------------------------------------------------------
    failed = [t.number for t in study.trials if t.state == TrialState.FAIL]
    require(len(study.trials) == HPO_TRIALS and not failed,
            f"hpo study: {len(study.trials)} trials, failed {failed} (tracebacks above)")
    routers = {t.params["model.router"] for t in study.trials}
    require(routers == {"token", "expert"}, f"hpo study routers {routers}")
    require((out / "best_config.yaml").exists(), "hpo study wrote no best_config.yaml")
    for trial, launches, _ in trials:
        b = trial.params["batch_size"]
        shapes = _trainer_shapes((TRAINER_FOLDS - 1) * per_fold, per_fold, b)
        steps = HPO_EPOCHS * shapes["steps"]
        evals = HPO_EPOCHS * shapes["val_batches"] + shapes["test_batches"]
        token = trial.params["model.router"] == "token"
        want = _counts(k1=steps + evals, k2f=DEPTH * (steps + evals), k2b=DEPTH * steps,
                       gmm=token * (6 * DEPTH * steps + 2 * DEPTH * evals),
                       tgmm=token * 2 * DEPTH * steps, drop=_draws(DEPTH, True) * steps)
        require(launches == want, f"hpo trial {trial.number} ({trial.params['model.router']}, "
                f"batch {b}) launches {launches}, expected {want}")
    print(f"hpo study: {HPO_TRIALS} trials in {study_s:.2f} s, states "
          f"{[t.state for t in study.trials]}, values {[t.value for t in study.trials]}, best "
          f"trial {study.best_trial.number} ({study.best_value}); launches {counts}  [{card}]",
          flush=True)

    analyze_study.main(["ast_moe_card", "--storage", str(db), "--out", str(out / "analysis"),
                        "--csv", "--html"])
    written = sorted(p.name for p in (out / "analysis").iterdir())
    require({"ast_moe_card_summary.json", "ast_moe_card_trials.csv"} <= set(written)
            and sum(name.endswith(".html") for name in written) == 5,
            f"analyze_study wrote {written}")
    summary = json.loads((out / "analysis" / "ast_moe_card_summary.json").read_text())
    require(summary["n_trials"] == HPO_TRIALS, f"analyze_study summary {summary}")
    debug = debug_optimize.main([*common, "optuna.study_name=ast_moe_debug", "optuna.n_trials=1"])
    require([t.state for t in debug.study.trials] == [TrialState.COMPLETE],
            f"debug_optimize trials {[t.state for t in debug.study.trials]}")
    print(f"hpo: analyze_study wrote {written}; debug_optimize ran 1 trial "
          f"({debug.study.trials[0].value})  [{card}]", flush=True)
    return counts


# --- phase 28: the vmapped HPO slice ----------------------------------------------------

VM_K, VM_TRIALS, VM_EPOCHS, VM_BATCH = 4, 6, 2, 16   # the study: 4 slots, 6 trials, batch 16
VM_SMALL_K = 8                                       # AST-Small's timed step: 8 trials
VM_TIMED = 3                                         # timed vmapped steps after one warm-up
VM_PARITY_K, VM_PARITY_BATCH, VM_PARITY_DEPTH = 2, 2, 2
VM_PARITY_ERR = 1e-4    # f32 both sides: the card's kernels under vmap against plain ops on
                        # the CPU, summation order only, through the cut depth
VM_SPACES = ("{optimizer.lr: {low: 1e-5, high: 1e-3, log: true}, "
             "optimizer.weight_decay: {low: 1e-6, high: 1e-2, log: true}, "
             "model.dropout: {low: 0.0, high: 0.3}, "
             "dataset.mixup_alpha: {low: 0.1, high: 1.0, log: true}, "
             "scheduler.T_max: {low: 1, high: 4}, scheduler.warmup_frac: {low: 0.0, high: 0.3}}")


def _vm_hyper(k: int, dropout: bool) -> dict:
    """K trials' hyperparameters: each its own lr and weight decay, MLP
    dropout 0, 0.05, ... with ``dropout``, a cosine over 100 steps."""
    i = np.arange(k)
    return dict(lr=1e-4 * (1 + i), wd=1e-4 * (1 + i), do=0.05 * i if dropout else 0 * i,
                tm=100.0 + 0 * i, wu=0 * i)


def _vm_exec(model, pipe, k: int, dev: torch.device, seed: int, **spaces):
    """A ``VmappedTrialRunner``'s functions for ``model`` and K fresh
    trials' states (``_vm_hyper``), without a datamodule or a study to run:
    (fns, states)."""
    from types import SimpleNamespace

    from dlsc_tpu_torch.hpo.vmapped import VmappedTrialRunner

    dm = SimpleNamespace(setup=lambda: None, num_classes=AST_BASE["num_classes"],
                         steps_per_epoch=25)
    runner = VmappedTrialRunner(None, model, pipe, dm, seed=seed, device=dev, **spaces)
    fns = runner._build_exec()
    hp = _vm_hyper(k, "do_space" in spaces)
    st = fns["init_v"]([seed * 1000 + j for j in range(k)], *hp.values())
    return fns, st


def _vm_row(name: str, k: int, dropout: bool, wave, labels, dev: torch.device,
            seed: int) -> dict:
    """One vmapped step of K trials of the bench's ``name`` (bf16,
    ``ln_fused``, per-trial mixup α; with ``dropout`` per-trial MLP dropout
    0..0.3): its launches counted and required, then ``VM_TIMED`` steps
    timed and one profiled."""
    from dlsc_tpu_torch.hpo.vmapped import TrialMetrics

    model = bench.build_model(name, seed, None, ln_fused=True)
    depth = model.config["depth"]
    spaces = dict(ma_space={"low": 0.1, "high": 1.0})
    if dropout:
        spaces["do_space"] = {"low": 0.0, "high": 0.3}
    fns, st = _vm_exec(model, bench.bench_pipeline(), k, dev, seed, **spaces)
    ls, ma = np.zeros(k, np.float32), np.linspace(0.2, 1.0, k).astype(np.float32)
    vms = TrialMetrics(k, AST_BASE["num_classes"], dev)

    def vm_step():
        return fns["train"](st, vms, ls, ma, wave, labels)[2]

    torch.cuda.reset_peak_memory_stats(dev)
    # --- a main path (one vmapped step): only these launches are counted -----------
    _reset_launches()
    loss = vm_step()
    torch.cuda.synchronize()
    counts = _launch_counts()
    # ----------------------------------------------------------------------------------
    # the K trials' masks in one launch a site and direction (no remat under vmap)
    require(counts == _counts(k1=1, k2f=depth, k2b=depth, k3f=depth * k, k3b=depth * k,
                              drop=_draws(depth, False) if dropout or model.dropout else 0),
            f"vmapped {name} step launches {counts}")
    require(bool(torch.isfinite(loss).all()), f"vmapped {name} losses {loss}")
    t0 = time.perf_counter()
    for _ in range(VM_TIMED):
        vm_step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / VM_TIMED
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    prof = bench.profile_calls(vm_step, n=1)
    del fns, st, vms, model
    torch.cuda.empty_cache()
    return dict(step_s=step_s, peak=peak, prof=prof, counts=counts)


def _kinds(prof: dict, key: str) -> dict:
    return {kind: round(v, 1) for kind, v in prof["by_kind_ms"].items()} | {
        "device": round(prof[key], 1)}


def _vm_timed_rows(dev: torch.device, seed: int, card: str) -> None:
    """One vmapped step timed (AST-Base bf16 at K 4 with per-trial dropout
    as the study runs it, AST-Small at K 8 without; batch 16 a trial,
    ``ln_fused``, per-trial mixup α), beside K sequential single-trial
    steps of the bench's step at the same batch (dropout 0), timed once
    after one warm-up, two of them profiled; the launches of a vmapped step
    and of the single steps required."""
    rng = np.random.default_rng(seed + 28)
    wave = torch.from_numpy((rng.standard_normal((VM_BATCH, CLIP)) * 0.3)
                            .astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, AST_BASE["num_classes"], VM_BATCH)).to(dev)
    print("  model      K  dropout  vmapped ms  clips/s  peak GiB  busy  |  K single steps "
          "ms  clips/s  peak GiB  busy", flush=True)
    with_dropout = None
    for name, k, dropout in (("ast", VM_K, True), ("ast_small", VM_SMALL_K, False)):
        r = _vm_row(name, k, dropout, wave, labels, dev, seed)
        with_dropout = with_dropout or r
        depth = DEPTH   # AST-Base and AST-Small alike
        step, state, ms, w, lab = bench.build(VM_BATCH, seed, dev, name, ln_fused=True)
        torch.cuda.reset_peak_memory_stats(dev)
        # --- a main path (K single-trial steps, the sequential runner's) -----------
        _reset_launches()
        state, ms, _, seq_s = bench.timed_steps(step, state, ms, w, lab, 1, k)
        counts_seq = _launch_counts()
        # ------------------------------------------------------------------------------
        seq_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        seq_prof = bench.profile_steps(step, state, ms, w, lab)
        n = 1 + k
        seq_drop = _draws(depth, True) * n if name == "ast_small" else 0   # AST-Base: none
        require(counts_seq == _counts(k1=n, k2f=depth * n, k2b=depth * n, k3f=2 * depth * n,
                                      k3b=depth * n, drop=seq_drop),
                f"single {name} steps {counts_seq}")
        del step, state, ms
        torch.cuda.empty_cache()
        vm_s = r["step_s"]
        print(f"  {name:9s} {k:2d}  {'0..0.3' if dropout else '0':7s}  {vm_s * 1e3:10.2f}  "
              f"{k * VM_BATCH / vm_s:7.2f}  {r['peak']:8.2f}  {r['prof']['busy_share']:.3f}  "
              f"|  {seq_s * k * 1e3:17.2f}  {VM_BATCH / seq_s:7.2f}  {seq_peak:8.2f}  "
              f"{seq_prof['busy_share']:.3f}  [{card}]", flush=True)
        print(f"vmapped step {name}: K {k} x batch {VM_BATCH}, bf16, ln_fused, no remat, "
              f"dropout {'0..0.3 per trial' if dropout else '0'}: {vm_s * 1e3:.3f} ms, "
              f"{k * VM_BATCH / vm_s:.2f} clips/s over the trials, peak {r['peak']:.2f} GiB, "
              f"busy {r['prof']['busy_share']:.3f}; launches a step {r['counts']}; {k} "
              f"single steps (remat attn_res, dropout 0) {seq_s * k * 1e3:.3f} ms, "
              f"{VM_BATCH / seq_s:.2f} clips/s, peak {seq_peak:.2f} GiB, busy "
              f"{seq_prof['busy_share']:.3f}; ratio {seq_s * k / vm_s:.3f}  [{card}]",
              flush=True)
        print(f"  profiled device ms by kind: vmapped "
              f"{_kinds(r['prof'], 'device_ms_per_call')}, {r['prof']['kernels_per_call']:.0f} "
              f"kernels; top { {m: round(v, 2) for m, v in list(r['prof']['top_kernels_ms'].items())[:6]} }; "
              f"one single step {_kinds(seq_prof, 'device_ms_per_step')}", flush=True)
    # per-trial dropout's cost: the same AST-Base step without it
    r = _vm_row("ast", VM_K, False, wave, labels, dev, seed)
    print(f"vmapped step ast: K {VM_K}, without dropout {r['step_s'] * 1e3:.3f} ms (device "
          f"{r['prof']['device_ms_per_call']:.3f} ms), with per-trial dropout "
          f"{with_dropout['step_s'] * 1e3:.3f} ms (device "
          f"{with_dropout['prof']['device_ms_per_call']:.3f} ms): dropout's cost "
          f"{(with_dropout['step_s'] - r['step_s']) * 1e3:+.3f} ms, device "
          f"{with_dropout['prof']['device_ms_per_call'] - r['prof']['device_ms_per_call']:+.3f}"
          f" ms  [{card}]", flush=True)


def _vm_folded_k2(dev: torch.device, gen: torch.Generator) -> None:
    """K2f and K2b under vmap (the trials folded into the batch, one launch)
    against one launch a trial at AST-Base's shape: equal."""
    from torch.func import vmap

    shape = (VM_K, VM_BATCH, HEADS, N_PAD, AST_BASE_WIDTH // HEADS)
    q, k, v, do = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16) for _ in range(4))
    out, lse = vmap(lambda a, b, c: attn_fast._mha_op(a, b, c, N_REAL))(q, k, v)
    grads = vmap(lambda *t: attn_fast._mha_bwd_op(*t, N_REAL))(q, k, v, out, lse, do)
    worst = 0.0
    for i in range(VM_K):
        o, l = attn_fast.fast_mha_forward(q[i], k[i], v[i], N_REAL)
        g = attn_fast.fast_mha_backward(q[i], k[i], v[i], o, l, do[i], N_REAL)
        pairs = [(out[i], o), (lse[i], l)] + [(a[i], b) for a, b in zip(grads, g)]
        worst = max(worst, *(norm_err(a, b) for a, b in pairs))
        require(all(torch.equal(a, b) for a, b in pairs) or worst <= 1e-6,
                f"K2 folded over the trials differs from trial {i}'s own launch: {worst}")
    print(f"vmapped K2: K {VM_K} x (B {VM_BATCH}, H {HEADS}, N {N_PAD}) bf16 in one K2f and "
          f"one K2b launch against one a trial: largest normalised difference {worst:.3e} "
          f"(equal or <= 1e-6)", flush=True)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``norm_err``, 0 where both are all zero."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def settled_entries(g: torch.Tensor) -> torch.Tensor:
    """The entries of one parameter's gradient whose Adam first update,
    lr · g / (|g| + eps), is set by the gradient and not by its rounding:
    |g| at least 1e-3 of the parameter's largest and 1e3 · eps. An entry
    whose gradient is a near-cancelling sum (the attention key bias's is 0
    in exact arithmetic) moves by lr times the sign of its rounding."""
    from dlsc_tpu_torch.hpo.vmapped import ADAM_EPS

    a = g.abs()
    return a >= max(1e-3 * float(a.max()), 1e3 * ADAM_EPS)


def beyond_spacing(got: torch.Tensor, want: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """|got − want| less one f32 spacing of the parameter ``p`` (CPU
    tensors), at least 0: the error of a parameter change, which is a
    difference of two f32 values."""
    return ((got - want).abs() - torch.from_numpy(np.spacing(p.abs().numpy()))).clamp_min(0)


def _vm_parity(dev: torch.device, seed: int) -> None:
    """One f32 vmapped step at K 2 (AST-Base widths, depth cut to 2,
    ``ln_fused``, dropout off, SpecAugment and Mixup draws replayed) on the
    card against each trial's step in plain ops on the CPU, normalised per
    parameter: the loss; the trial's clipped + L2 gradient g through Adam's
    moments after one step (0.1 g and 0.001 g²); the parameter change
    against −lr · schedule · g / (|g| + eps) beyond one f32 spacing of the
    parameter, on the ``settled_entries`` of g (the others counted and
    printed); each trial's step count 1."""
    from dlsc_tpu_torch.hpo.vmapped import (ADAM_B1, ADAM_B2, ADAM_EPS, TrialMetrics,
                                            schedule_factor)

    K, B = VM_PARITY_K, VM_PARITY_BATCH
    cfg = dict(num_classes=AST_BASE["num_classes"], emb_dim=AST_BASE_WIDTH,
               depth=VM_PARITY_DEPTH, num_heads=HEADS, patch_size=16, patch_stride=10,
               overlap=6, ln_fused=True)
    pipe = bench.bench_pipeline()
    model = ASTViT(**cfg, generator=torch.Generator().manual_seed(seed))
    fns, st = _vm_exec(model, pipe, K, dev, seed)
    flat0 = st.flat.cpu().clone()
    rng = np.random.default_rng(seed + 281)
    wave = torch.from_numpy((rng.standard_normal((B, CLIP)) * 0.3).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg["num_classes"], B))
    draws = [pipe.draw(B, CLIP, np.random.default_rng(seed + i), alpha)
             for i, alpha in enumerate((0.4, 2.0))]
    ls, ma = np.asarray([0.0, 0.1], np.float32), np.asarray([0.4, 2.0], np.float32)
    _, _, loss = fns["train"](st, TrialMetrics(K, cfg["num_classes"], dev), ls, ma,
                              wave.to(dev), labels.to(dev), draws=draws, dropout_seed=0)
    require(st.count.tolist() == [1] * K, f"vmapped parity step counts {st.count.tolist()}")
    mu, nu, delta = st.mu.cpu(), st.nu.cpu(), st.flat.cpu() - flat0
    hyper = {n: torch.tensor(v, dtype=torch.float32) for n, v in _vm_hyper(K, False).items()}
    worst = dict(loss=0.0, grad=0.0, grad_sq=0.0, change=0.0)
    left_out = 0
    for i in range(K):
        ref = ASTViT(**cfg)
        off = 0
        with torch.no_grad():
            for (name, shape), p in zip(st.shapes, ref.parameters()):
                n = int(np.prod(shape))
                p.copy_(flat0[i, off:off + n].view(shape))
                off += n
        x, y = pipe.train_batch(wave, labels, draws[i])
        y_s = y * (1 - ls[i]) + ls[i] / y.shape[-1]
        ref_loss = CrossEntropyLoss()(ref.train()(x), y_s)
        ref_loss.backward()
        g = torch.cat([p.grad.reshape(-1) for p in ref.parameters()])
        norm = g.double().square().sum().sqrt().float()   # f32 vector_norm drifts at 1e7 terms
        g = g if norm < 1.0 else g / norm
        g = g + hyper["wd"][i] * flat0[i]
        lr = hyper["lr"][i] * schedule_factor(0, hyper["tm"][i], hyper["wu"][i])
        upd = -lr * g / (g.abs() + ADAM_EPS)
        worst["loss"] = max(worst["loss"], abs(float(loss[i]) - ref_loss.item())
                            / abs(ref_loss.item()))
        off = 0
        for name, shape in st.shapes:
            n = int(np.prod(shape))
            sl = slice(off, off + n)
            worst["grad"] = max(worst["grad"], _rel_err(mu[i, sl], (1 - ADAM_B1) * g[sl]))
            worst["grad_sq"] = max(worst["grad_sq"],
                                   _rel_err(nu[i, sl], (1 - ADAM_B2) * g[sl].square()))
            keep = settled_entries(g[sl])
            require(bool(keep.any()), f"vmapped parity: no settled gradient entry in {name}")
            left_out += int((~keep).sum())
            beyond = beyond_spacing(delta[i, sl], upd[sl], flat0[i, sl])[keep]
            worst["change"] = max(worst["change"], float(beyond.max())
                                  / float(upd[sl].abs().max().clamp_min(1e-30)))
            off += n
    print(f"vmapped parity: f32 K {K} x batch {B}, AST-Base widths at depth "
          f"{VM_PARITY_DEPTH}, ln_fused, the draws replayed: card (kernels under vmap) vs "
          f"CPU plain ops per trial: loss {worst['loss']:.3e}, clipped + L2 gradient "
          f"{worst['grad']:.3e} (Adam's mu), its square {worst['grad_sq']:.3e} (nu), "
          f"parameter change {worst['change']:.3e} beyond one f32 spacing on the settled "
          f"entries ({left_out} of {K * flat0.shape[1]} left out: |g| below 1e-3 of the "
          f"parameter's largest or 1e3 eps) (all <= {VM_PARITY_ERR})", flush=True)
    require(max(worst.values()) <= VM_PARITY_ERR, f"vmapped parity {worst}")


def lockstep_epochs(trials: list, k: int) -> int:
    """The lockstep epochs that ``VmappedTrialRunner.run_continuous`` ran
    for ``trials`` (in ask order) through ``k`` slots: each trial trains as
    many epochs as it reported; a slot freed at the end of an epoch takes
    the next trial (slots in index order), and the run ends with its last
    busy slot."""
    ends = [len(t.intermediate_values) for t in trials[:k]]
    for t in trials[k:]:
        i = min(range(k), key=lambda j: ends[j])
        ends[i] += len(t.intermediate_values)
    return max(ends)


def phase_vmapped_hpo(dev: torch.device, seed: int, tmp: Path, card: str,
                      gen: torch.Generator) -> dict:
    """Phase 28: ``optimize_hyperparams model=ast +model.ln_fused=true
    +optuna.vmapped.enabled=true`` on phase 18's shards (``tmp / "data"``):
    AST-Base at full width and depth, bf16, K 4 slots recycled over 6 trials
    of 2 epochs at batch 16, searching lr, weight decay, dropout, mixup α,
    T_max and warmup; every trial COMPLETE or PRUNED with its own lr, the db
    reloaded, the study's launches exact. Then the timed vmapped steps,
    K2's folded launch against one a trial, and the card-vs-CPU parity.
    Returns the study's launch counts."""
    from dlsc_tpu_torch import hpo
    from dlsc_tpu_torch.scripts import optimize_hyperparams

    out, db = tmp / "hpo_vmapped", tmp / "hpo_vmapped" / "study.db"
    per_fold = TRAINER_CLASSES * TRAINER_CLIPS
    shapes = _trainer_shapes((TRAINER_FOLDS - 1) * per_fold, per_fold, VM_BATCH)
    torch.cuda.reset_peak_memory_stats(dev)
    # --- the main path: only these launches are counted -------------------------
    _reset_launches()
    t0 = time.perf_counter()
    study = optimize_hyperparams.main([
        "model=ast", "+model.ln_fused=true", f"dataset.root={tmp / 'data'}",
        "dataset.fold=0", "trainer.precision=bf16-mixed", f"batch_size={VM_BATCH}",
        f"trainer.max_epochs={VM_EPOCHS}", f"seed={seed}", f"optuna.n_trials={VM_TRIALS}",
        f"optuna.storage_path=sqlite:///{db}", f"optuna.output_dir={out}",
        "optuna.study_name=ast_vmapped_card", "+optuna.vmapped.enabled=true",
        f"+optuna.vmapped.k={VM_K}", "+optuna.vmapped.continuous=true",
        "+optuna.vmapped.mesh=true",   # one card: one process, as without it
        f"+optuna.vmapped.spaces={VM_SPACES}"])
    torch.cuda.synchronize()
    study_s = time.perf_counter() - t0
    counts = _launch_counts()
    # ------------------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    trials = study.trials
    states = {str(t.state) for t in trials}
    require(len(trials) == VM_TRIALS and states <= {"COMPLETE", "PRUNED"},
            f"vmapped study: {len(trials)} trials, states {[str(t.state) for t in trials]}")
    require(len({t.params["optimizer.lr"] for t in trials}) == VM_TRIALS,
            f"vmapped study lrs {[t.params['optimizer.lr'] for t in trials]}")
    searched = {"optimizer.lr", "optimizer.weight_decay", "model.dropout",
                "dataset.mixup_alpha", "scheduler.T_max", "scheduler.warmup_frac"}
    require(all(searched <= set(t.params) and t.intermediate_values for t in trials),
            f"vmapped study params {[sorted(t.params) for t in trials]}")
    reloaded = hpo.Study("ast_vmapped_card", db, "maximize").trials
    require([(t.params, str(t.state), t.value) for t in reloaded]
            == [(t.params, str(t.state), t.value) for t in trials], "vmapped study db reload")
    epochs = lockstep_epochs(trials, VM_K)
    steps, evals = epochs * shapes["steps"], epochs * shapes["val_batches"]
    want = _counts(k1=steps + evals, k2f=DEPTH * (steps + evals), k2b=DEPTH * steps,
                   k3f=DEPTH * VM_K * (steps + evals), k3b=DEPTH * VM_K * steps,
                   drop=_draws(DEPTH, False) * steps)
    require(counts == want, f"vmapped study launches {counts}, expected {want} for "
            f"{epochs} lockstep epochs of {shapes['steps']} steps and "
            f"{shapes['val_batches']} eval batches")
    print(f"vmapped study: AST-Base bf16 ln_fused, {VM_TRIALS} trials through {VM_K} slots, "
          f"{VM_EPOCHS} epochs a trial, batch {VM_BATCH} a trial: {epochs} lockstep epochs "
          f"x {shapes['steps']} steps in {study_s:.2f} s, peak {peak:.2f} GiB; states "
          f"{[str(t.state) for t in trials]}, values {[t.value for t in trials]}; launches "
          f"{counts}  [{card}]", flush=True)
    for t in trials:
        print(f"  trial {t.number}: {t.state} {t.value} epochs {len(t.intermediate_values)} "
              f"params { {k: round(v, 6) for k, v in t.params.items()} }", flush=True)
    torch.cuda.empty_cache()
    took = {"study": study_s}
    for part, run in (("timed rows", lambda: _vm_timed_rows(dev, seed, card)),
                      ("K2 folded", lambda: _vm_folded_k2(dev, gen)),
                      ("parity", lambda: _vm_parity(dev, seed))):
        t0 = time.perf_counter()
        run()
        took[part] = time.perf_counter() - t0
    print(f"phase 28 parts: { {part: round(t, 1) for part, t in took.items()} } s", flush=True)
    return counts


# --- the dropout draw (csrc/dropout_draw.cu) ------------------------------------------

# the main paths' dropout sites, bf16, at the training batch 64: AST-Base's MLP
# (phase 5's model; its bench step has no dropout, the vmapped study's does)
# and AST-MoE's ragged experts' hidden units (the sorted rows) and block output
# (phase 10); (name, shape, row-indexed)
DRAW_SITES = (("AST-Base MLP hidden", (TRAIN_BATCH, N_PAD, 4 * AST_BASE_WIDTH), False),
              ("AST-Base MLP output", (TRAIN_BATCH, N_PAD, AST_BASE_WIDTH), False),
              ("AST-MoE experts' hidden, sorted rows", (MOE_ROWS, MOE_FF), True),
              ("AST-MoE block output", (TRAIN_BATCH, MOE_N_PAD, MOE_DIM), False))
DRAW_RATE = 0.1
DRAW_OPS = 30   # integer operations an element: a Philox block's ~100 over its 4
                # elements, the compare, the divide and the select; counted
                # against the f32 rate, which is no lower than the integer one


def _draw_args(shape: tuple, rows: bool, dev: torch.device, g: torch.Generator,
               dtype=torch.bfloat16) -> dict:
    """``dropout_draw._run``'s arguments at a site: x on the card, its
    unsplit geometry, and for the sorted rows their (token, choice) pairs."""
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    row_ids = None
    if rows:   # a permutation of the pairs of the batch's real tokens
        row_ids = torch.randperm(shape[0], generator=g, device=dev)
        strides, base = [shape[-1]], 0
    else:
        strides, base = dropout_draw.geometry(shape)
    return dict(x=x[None], seeds=torch.tensor([int(torch.randint(2**62, (), generator=g,
                                                                   device=dev))]),
                keep=torch.tensor([1.0 - DRAW_RATE]), block=3, site=1, strides=strides,
                base=base, row_ids=None if row_ids is None else row_ids[None])


def phase_draw(dev: torch.device, gen: torch.Generator) -> dict:
    """The dropout draw's kernel against its plain version, bit for bit: at
    the ``DRAW_SITES`` (bf16), at one f32 site, in its keep-mask mode, at a
    rank's rows and heads (a slice of the unsplit draw), and under the vmap
    rule (4 trials' seeds and rates, one launch) against each trial's plain
    draw; registers and no spill (``-Xptxas -v``). Timed at each site
    (events): the kernel, the plain version, the draw it replaced
    (``torch.rand`` of the same count, the compare and the scale), and
    ``F.dropout`` (its own bits; the yardstick of one PyTorch call)."""
    from torch.func import vmap

    build = _build_report("dropout_draw")
    g = torch.Generator(dev).manual_seed(int(torch.randint(2**31, (1,), generator=gen)))
    D = dropout_draw
    rows, worst = [], None
    for name, shape, by_row in DRAW_SITES:
        a = _draw_args(shape, by_row, dev, g)
        args = (a["x"], a["seeds"], a["keep"], a["block"], a["site"], a["strides"], a["base"],
                a["row_ids"])
        got, want = D._run(1, *args), D._plain(1, *args)
        require(torch.equal(got, want), f"dropout draw at {name}: kernel != plain version")
        x, keep = a["x"][0], 1.0 - DRAW_RATE
        k_ms = float(np.median(cuda_times(lambda: D._run(1, *args))))
        p_ms = float(np.median(cuda_times(lambda: D._plain(1, *args), iters=2, warmup=1)))
        rand_ms = float(np.median(cuda_times(lambda: torch.where(
            torch.rand(x.shape, device=dev) < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                                          device=dev)))))
        lib_ms = float(np.median(cuda_times(lambda: F.dropout(x, DRAW_RATE, True))))
        n = x.numel()
        b = bound(DRAW_OPS * n, F32_FLOPS, 2 * n * x.element_size()
                  + (8 * shape[0] if by_row else 0))
        kept = (got[0] != 0).float().mean().item()
        rows.append(dict(site=name, shape=list(shape), ms=k_ms, plain_ms=p_ms, rand_ms=rand_ms,
                         library_ms=lib_ms, kept=kept, **b))
        print(f"dropout draw, {name} {tuple(shape)} bf16 rate {DRAW_RATE}: bit-equal to the "
              f"plain version; kernel {k_ms:.4f} ms (bound {b['bound_ms']:.4f} ms by "
              f"{b['bound_by']}, share {b['bound_ms'] / k_ms:.3f}), plain {p_ms:.2f} ms, "
              f"torch.rand + compare + scale {rand_ms:.4f} ms, F.dropout {lib_ms:.4f} ms; kept "
              f"{kept:.5f}", flush=True)
        del got, want, a, args, x
        torch.cuda.empty_cache()
    # f32, the mask mode, a rank's rows and heads, the vmap rule
    x = torch.randn((TRAIN_BATCH, MOE_N_PAD, MOE_DIM), generator=g, device=dev)
    whole = D.dropout(x, DRAW_RATE, D.Draw(5, 2), 2)
    require(torch.equal(whole, D._plain(1, x[None], torch.tensor([5]), torch.tensor([0.9]), 2,
                                        2, *D.geometry(tuple(x.shape)), None)[0]),
            "dropout draw f32: kernel != plain version")
    mask = D.keep_mask(tuple(x.shape), DRAW_RATE, 5, 2, 2, device=dev)
    require(torch.equal(mask, D._plain(0, x[None], torch.tensor([5]), torch.tensor([0.9]), 2, 2,
                                       *D.geometry(tuple(x.shape)), None)[0]),
            "dropout draw: the keep mask differs from the plain version's")
    part = D.dropout(x[16:48, :, 128:256].contiguous(), DRAW_RATE,
                     D.Draw(5, 2, (16, 32, TRAIN_BATCH)), 2, part=(2, 1, 3))
    require(torch.equal(part, whole[16:48, :, 128:256]),
            "dropout draw: a rank's rows and units != that slice of the unsplit draw")
    seeds = D.trial_seeds(9, range(VM_K))
    rates = torch.linspace(0.0, 0.3, VM_K, device=dev)
    xs = x[:VM_K * 4].view(VM_K, 4, MOE_N_PAD, MOE_DIM)
    before = D.launches
    folded = vmap(lambda xi, s, r: D.dropout(xi, r, D.Draw(s, 1), 1), randomness="error")(
        xs, seeds, rates)
    require(D.launches - before == 1, f"vmapped draw: {D.launches - before} launches, not 1")
    for i in range(VM_K):
        want = D._plain(1, xs[i][None], seeds[i:i + 1], 1.0 - rates[i:i + 1], 1, 1,
                        *D.geometry(tuple(xs[i].shape)), None)[0]
        require(torch.equal(folded[i], want), f"vmapped draw: trial {i} != its plain draw")
    print(f"dropout draw: f32, the keep mask, a rank's rows x units and {VM_K} vmapped trials "
          "(one launch) bit-equal to the plain version", flush=True)
    site = rows[2]
    return dict(max_abs_err=0.0, ms=site["ms"], plain_ms=site["plain_ms"],
                bound_ms=site["bound_ms"], bound_by=site["bound_by"],
                library_ms=site["library_ms"], rand_ms=site["rand_ms"], sites=rows, build=build)


# --- phases 29-30: the multi-device layer (dlsc_tpu_torch/parallel) --------------------

MULTI_BATCH, MULTI_STEPS, MULTI_MICRO = 16, 2, 2   # the global batch, steps, GPipe micros
MULTI_GRAD = 2e-2       # a mode's step-1 gradients (gathered from its ranks) against the
                        # one-process step of the same model on the same card and batch,
                        # normalised per parameter: the K2 bf16 bar (ATTN_BF16_ERR). The
                        # same kernels on both sides; what differs is the split (rows,
                        # heads, stages, experts) and the order of the ranks' sums
MULTI_MODES = (("ddp", "ast"), ("fsdp", "ast"), ("tp", "ast"), ("pp", "ast"),
               ("moe_ddp", "ast_moe"), ("ep", "ast_moe_einsum"))


def _multi_model(kind: str, seed: int, dev: torch.device) -> torch.nn.Module:
    """Phase 29's models at full width, bf16, remat attn_res: AST-Base with
    ln_fused; AST-MoE on the ragged dispatch; AST-MoE on einsum (what the
    ragged dispatch lowers to under expert parallelism)."""
    gen = torch.Generator().manual_seed(seed)
    remat = dict(remat=True, remat_policy="attn_res", generator=gen, device=dev)
    if kind == "ast":
        return ASTModel(**AST_BASE, dtype=torch.bfloat16, ln_fused=True, **remat)
    if kind == "ast_base":
        return ASTModel(**AST_BASE, dtype=torch.bfloat16, **remat)
    dispatch = "einsum" if kind == "ast_moe_einsum" else "ragged"
    dtype = torch.float32 if kind == "ast_moe_f32" else torch.bfloat16
    return ASTMoE(**{**AST_MOE, "dispatch": dispatch}, dtype=dtype, **remat)


def _multi_layout(mode: str, model, n: int, dev: torch.device):
    """``model`` laid out over the group's ``n`` ranks as ``mode`` says."""
    from dlsc_tpu_torch import parallel
    from dlsc_tpu_torch.parallel import ep, pp, tp

    dt = dev.type
    if mode in ("ddp", "moe_ddp"):
        return parallel.DataParallel(model, parallel.MeshPlan(parallel.get_mesh(n, 1, dt)), dev)
    if mode == "fsdp":
        return parallel.FullyShardedDP(model, parallel.MeshPlan(parallel.get_mesh(n, 1, dt)))
    if mode == "tp":
        return tp.tensor_parallel(model, parallel.get_mesh(n, n, dt))
    if mode == "pp":
        return pp.Pipeline(model, parallel.MeshPlan(pp.get_pp_mesh(n, n, dt)), MULTI_MICRO)
    return ep.ExpertParallel(model, parallel.MeshPlan(parallel.get_mesh(n, n, dt),
                                                      ("data", "model")))


def _multi_batch(seed: int, dev: torch.device):
    """The global batch (the same on every rank), its draws for each step."""
    pipe = bench.bench_pipeline()
    rng = np.random.default_rng(seed + 29)
    wave = torch.from_numpy((rng.standard_normal((MULTI_BATCH, CLIP)) * 0.3)
                            .astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, AST_BASE["num_classes"], MULTI_BATCH)).to(dev)
    return pipe, wave, labels, [pipe.draw(MULTI_BATCH, CLIP, rng) for _ in range(MULTI_STEPS)]


def _multi_steps(model, layout, seed: int, dev: torch.device, topk=None) -> dict:
    """``MULTI_STEPS`` SGD + momentum steps (momentum buffers after step 1 =
    the gradients): step 1's loss and gathered gradients (on rank 0), the
    launches per step, the second step's time, the peak memory. ``topk``:
    the MoE routers' choice (a ``RouteLog``'s record or replay)."""
    from dlsc_tpu_torch.parallel.data import is_writer
    from dlsc_tpu_torch.train.checkpoint import plain_state_dict

    pipe, wave, labels, draws = _multi_batch(seed, dev)
    state = TrainState.create(model, sgd(lr=1e-4, momentum=0.9), None, 1)
    state.parallel = layout
    step = make_train_step(pipe, CrossEntropyLoss(), topk=topk)
    ms = MetricState.create(AST_BASE["num_classes"], dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    _reset_launches()   # the gathers between the steps launch no kernel
    for i in range(MULTI_STEPS):
        t0 = time.perf_counter()
        state, ms, loss = step(state, ms, wave, labels, draws[i], seed + i)
        torch.cuda.synchronize(dev)
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
        if i == 0:
            out["loss"] = loss.item()
            full = plain_state_dict(state) if layout is None else layout.full_state(state)
            if is_writer():
                names = [n for n, _ in model.named_parameters()] if layout is None \
                    else layout.full_names
                opt = full["optimizer"]["state"]
                out["grads"] = {n: opt[j]["momentum_buffer"].clone() for j, n in enumerate(names)}
            del full
    out["total"] = _launch_counts()   # over the steps
    out["counts"] = {k: v / MULTI_STEPS for k, v in out["total"].items()}
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def _multi_rank(seed: int, modes: tuple, device_type: str = "cuda") -> dict | None:
    """One rank of phase 29 (spawned): every mode's steps, then, on rank 0,
    each model's one-process step and the comparisons."""
    import torch.distributed as dist

    from dlsc_tpu_torch.parallel.mesh import local_device

    dev = local_device(device_type)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = dist.get_world_size()
    runs = {}
    for mode, kind in modes:
        model = _multi_model(kind, seed, dev)
        runs[mode] = _multi_steps(model, _multi_layout(mode, model, n, dev), seed, dev)
        del model
        torch.cuda.empty_cache()
    if dist.get_rank() != 0:
        return None
    refs = {}
    for kind in dict(modes).values():   # the one-process step of each model, no layout
        if kind not in refs:
            refs[kind] = _multi_steps(_multi_model(kind, seed, dev), None, seed, dev)
            torch.cuda.empty_cache()
    out = {}
    for mode, kind in modes:
        got, want = runs[mode], refs[kind]
        errs = sorted(((norm_err(got["grads"][k], g), k) for k, g in want["grads"].items()
                       if g.abs().max() > 0), reverse=True)
        out[mode] = dict(loss=got["loss"], ref_loss=want["loss"],
                         loss_err=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
                         grad_err=errs[0][0], worst=errs[:3], counts=got["counts"],
                         total=got["total"],
                         ref_counts=want["counts"], step_ms=got["step_ms"],
                         ref_step_ms=want["step_ms"], peak_gib=got["peak_gib"],
                         ref_peak_gib=want["peak_gib"])
    return out


def _expected_multi(mode: str, n: int, ref: dict) -> dict:
    """A mode's launches per rank per step from the one-process step's: a
    stage runs its share of the blocks on every microbatch."""
    if mode != "pp":
        return ref
    per_block = {k: v for k, v in ref.items() if k != "k1"}
    return dict(k1=ref["k1"], **{k: v / n * MULTI_MICRO for k, v in per_block.items()})


def phase_multi_device(dev: torch.device, seed: int, tmp: Path, card: str) -> dict:
    """Phase 29: every mode at W = the visible cards, over NCCL, the ranks
    started by the port's launcher (``parallel.mesh.spawn``): DDP, FSDP, TP
    (degree W), PP (W stages, 2 microbatches) on AST-Base (bf16, ln_fused),
    the ragged AST-MoE under DDP and AST-MoE with its experts over W ranks;
    global batch 16, 2 steps each. Step 1's loss and gathered gradients
    against the one-process step (``MULTI_GRAD``), the launches per rank
    per step. Then ``scripts.train trainer.devices=auto trainer.fsdp=true``
    fits briefly on phase 18's shards, and ``export`` and the server answer
    one request from its checkpoint. Returns the counts of rank 0's DDP run."""
    from dlsc_tpu_torch.parallel.mesh import spawn
    from dlsc_tpu_torch.scripts import export
    from dlsc_tpu_torch.scripts import train as train_cli

    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    res = spawn(_multi_rank, n, seed, MULTI_MODES, backend="nccl", device_type="cuda",
                timeout_s=600)[0]
    modes_s = time.perf_counter() - t0
    for mode, kind in MULTI_MODES:
        r = res[mode]
        want = _expected_multi(mode, n, r["ref_counts"])
        print(f"multi-device {mode} ({kind}, W={n}, NCCL, batch {MULTI_BATCH}): loss "
              f"{r['loss']:.6f} vs one process {r['ref_loss']:.6f} (rel {r['loss_err']:.2e}, "
              f"<= {STEP_BF16_LOSS}); gradients {r['grad_err']:.3e} (<= {MULTI_GRAD}; "
              f"largest {', '.join(f'{k} {e:.1e}' for e, k in r['worst'])}); launches per rank "
              f"per step {r['counts']} (one process {r['ref_counts']}); step 2 "
              f"{r['step_ms']:.1f} ms vs {r['ref_step_ms']:.1f} ms one process; peak "
              f"{r['peak_gib']:.2f} GiB vs {r['ref_peak_gib']:.2f} GiB  [{card}]", flush=True)
        require(r["loss_err"] <= STEP_BF16_LOSS and r["grad_err"] <= MULTI_GRAD,
                f"phase 29 {mode}: step 1 differs from the one-process step")
        require(r["counts"] == want and r["counts"]["k1"] == 1
                and min(r["counts"][k] for k in ("k2f", "k2b")) > 0,
                f"phase 29 {mode}: launches {r['counts']}, expected {want}")
    print(f"multi-device modes: {modes_s:.1f} s (spawn, NCCL groups, 6 modes x "
          f"{MULTI_STEPS} steps, 3 one-process references)  [{card}]", flush=True)

    # --- the train CLI on the visible cards, FSDP; export and serve ----------------
    os.environ["DLSC_TRACKING_DIR"] = str(tmp / "mruns")
    common = [f"dataset.root={tmp / 'data'}", "dataset.fold=0", "trainer.precision=bf16-mixed",
              f"batch_size={MULTI_BATCH}", f"checkpoint.dirpath={tmp / 'mckpt'}",
              f"hydra.run.dir={tmp / 'mrun'}", f"seed={seed}"]
    t0 = time.perf_counter()
    out = train_cli.main(["model=ast", *common, "trainer.devices=auto", "+trainer.fsdp=true",
                          "trainer.max_epochs=1", "+trainer.limit_train_batches=2",
                          "+trainer.limit_val_batches=1"])
    fit_s = time.perf_counter() - t0
    best = sorted((tmp / "mckpt").glob("*/state.pt"))
    require(bool(best) and np.isfinite(out["test/loss"]), f"FSDP train CLI: {best}, {out}")
    art = export.main(["model=ast", f"+ckpt_path={best[0].parent}", f"+out={tmp / 'mart'}",
                       "+dtype=bfloat16", f"+batch={SERVE_BATCH}", f"+clip_samples={CLIP}"])
    server = ModelServer(art, device="cuda", window_ms=5.0)
    httpd = server.make_http_server("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        clip = (np.random.default_rng(seed).standard_normal(CLIP) * 0.1).astype(np.float32)
        status, resp = _post(httpd.server_address[1], "/predict_raw",
                             json.dumps({"pcm": clip.tolist(),
                                         "sample_rate": AST_BASE["sample_rate"]}).encode())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    probs = _check_probs(status, resp, "phase 29 served request")
    print(f"multi-device train CLI (trainer.devices=auto, fsdp, W={n}): 1 epoch x 2 steps + "
          f"test in {fit_s:.1f} s, test loss {out['test/loss']:.4f}; export of "
          f"{best[0].parent.name} served one request (top prob {probs.max():.4f})  [{card}]",
          flush=True)
    return res["ddp"]["total"]


def _two_ranks_one_card(seed: int, device_type: str = "cuda") -> dict | None:
    """One of phase 30's two ranks (gloo, CUDA tensors, one card): DDP steps
    of AST-Base; rank 0 adds the one-process step at the global batch."""
    import torch.distributed as dist

    from dlsc_tpu_torch.parallel.mesh import local_device

    dev = local_device(device_type)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _multi_model("ast_base", seed, dev)
    got = _multi_steps(model, _multi_layout("ddp", model, 2, dev), seed, dev)
    if dist.get_rank() != 0:
        return None
    del model
    torch.cuda.empty_cache()
    want = _multi_steps(_multi_model("ast_base", seed, dev), None, seed, dev)
    errs = sorted(((norm_err(got["grads"][k], g), k) for k, g in want["grads"].items()
                   if g.abs().max() > 0), reverse=True)
    return dict(loss=got["loss"], ref_loss=want["loss"],
                loss_err=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
                grad_err=errs[0][0], worst=errs[:3], counts=got["counts"], total=got["total"],
                step_ms=got["step_ms"], ref_step_ms=want["step_ms"], peak_gib=got["peak_gib"])


def phase_two_ranks_one_card(dev: torch.device, seed: int, card: str) -> dict:
    """Phase 30: two DDP ranks on the one card over a gloo group on CUDA
    tensors (gloo has all_reduce and broadcast for them, all DDP needs;
    NCCL refuses two ranks on one device). AST-Base bf16, SpecAugment and
    Mixup, global batch 16 (8 a rank): each rank featurises its rows and
    their Mixup partners in one K1 call. It measures no interconnect."""
    from dlsc_tpu_torch.parallel.mesh import spawn

    t0 = time.perf_counter()
    r = spawn(_two_ranks_one_card, 2, seed, backend="gloo", device_type="cuda",
              device_ids=[0, 0], timeout_s=600)[0]
    print(f"two ranks on one card (gloo, DDP, AST-Base bf16, batch {MULTI_BATCH} = 2 x 8): "
          f"loss {r['loss']:.6f} vs one process {r['ref_loss']:.6f} (rel {r['loss_err']:.2e}); "
          f"gradients {r['grad_err']:.3e} (<= {MULTI_GRAD}; largest "
          f"{', '.join(f'{k} {e:.1e}' for e, k in r['worst'])}); launches per rank per step "
          f"{r['counts']}; step 2 {r['step_ms']:.1f} ms vs {r['ref_step_ms']:.1f} ms one "
          f"process; peak {r['peak_gib']:.2f} GiB a rank; {time.perf_counter() - t0:.1f} s  "
          f"[{card}]", flush=True)
    require(r["loss_err"] <= STEP_BF16_LOSS and r["grad_err"] <= MULTI_GRAD,
            "phase 30: the two ranks' step differs from the one-process step")
    require(r["counts"] == _counts(k1=1, k2f=DEPTH, k2b=DEPTH),
            f"phase 30: launches per rank per step {r['counts']}")
    return r["total"]


# --- phase 31: two ranks on one card: TP on AST-MoE, the sharded vmapped study ----------

SHARD_BATCH, SHARD_TRAIN, SHARD_VAL = 8, 3, 2   # a trial's batch, train and val batches
SHARD_LR = {"low": 1e-5, "high": 1e-4, "log": True}   # the sharded study's lr space
SHARD_PARAM_ERR = 1e-3  # a trial's parameters (one f32 vector) after the study, two ranks
                        # against one process, over the vector's largest value: where the
                        # two runs round apart, an Adam step moves an entry whose gradient
                        # cancels by lr times the sign of its rounding, so 3 steps at lr
                        # <= 1e-4 move it by <= 6e-4 apart (the LayerNorm weights are 1)


class _FewBatches:
    """A datamodule's first ``train`` train batches an epoch and ``val``
    validation batches (a study of a few steps)."""

    def __init__(self, dm, train: int, val: int):
        self.dm, self.train, self.val = dm, train, val
        self.num_classes = dm.num_classes
        self.steps_per_epoch = train

    def setup(self) -> None:
        self.dm.setup()

    def train_batches(self, epoch: int = 0, seed: int | None = None):
        return itertools.islice(self.dm.train_batches(epoch=epoch, seed=seed), self.train)

    def val_batches(self):
        return itertools.islice(self.dm.val_batches(), self.val)


def _sharded_study(seed: int, root: str, out: str, dev: torch.device) -> dict:
    """A vmapped AST-Base study (bf16, ``ln_fused``, K ``VM_K``, per-trial
    dropout and mixup α, one epoch of ``SHARD_TRAIN`` steps at batch
    ``SHARD_BATCH`` a trial) through ``VmappedTrialRunner.run_batch``; in a
    process group its trials split over the ranks (``plan``), the study on
    rank 0. Each rank saves its trials' parameters under ``out``; returns
    the history, values, trial numbers, the trials' hyperparameters (rank 0),
    the launches and the seconds."""
    import torch.distributed as dist

    from dlsc_tpu_torch import hpo, parallel
    from dlsc_tpu_torch.data.datamodule import ESC50DataModule
    from dlsc_tpu_torch.hpo.vmapped import VmappedTrialRunner

    grouped = dist.is_initialized()
    lead = not grouped or dist.get_rank() == 0
    tag = "two" if grouped else "one"
    dm = ESC50DataModule(root=root, num_classes=TRAINER_CLASSES, fold=0, val_split=0.2,
                         batch_size=SHARD_BATCH, preprocessing_mode="ast", is_spectrogram=True)
    study = hpo.Study(f"sharded_{tag}", Path(out) / f"{tag}.db", "maximize",
                      sampler=hpo.TPESampler(seed=seed)) if lead else None
    runner = VmappedTrialRunner(
        study, bench.build_model("ast", seed, None, ln_fused=True), bench.bench_pipeline(),
        _FewBatches(dm, SHARD_TRAIN, SHARD_VAL), epochs=1, seed=seed, device=dev,
        lr_space=SHARD_LR, do_space={"low": 0.0, "high": 0.3},
        ma_space={"low": 0.1, "high": 1.0},
        plan=parallel.make_plan("cuda") if grouped else None)
    torch.cuda.synchronize(dev)
    _reset_launches()
    t0 = time.perf_counter()
    res = runner.run_batch(k=VM_K)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    counts = _launch_counts()
    st = res.states
    for j in range(st.k):
        torch.save(st.flat[j].cpu(), Path(out) / f"{tag}-slot{runner.slot0 + j}.pt")
    return dict(history=res.history, values=res.values, numbers=res.trial_numbers,
                params=[t.params for t in study.trials] if lead else None, counts=counts,
                seconds=secs, peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)


def _phase31_rank(seed: int, root: str, out: str) -> dict:
    """One of phase 31's two ranks (gloo, CUDA tensors, one card): AST-MoE's
    TP = 2 train steps in f32 and in bf16 (rank 0 adds the one-process
    steps on the same routes and compares), then its half of the sharded
    vmapped study."""
    import torch.distributed as dist

    from dlsc_tpu_torch import parallel
    from dlsc_tpu_torch.parallel import tp
    from dlsc_tpu_torch.parallel.mesh import local_device

    dev = local_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_tp = {}
    for kind in ("ast_moe_f32", "ast_moe"):
        model = _multi_model(kind, seed, dev)
        log = RouteLog()
        got = _multi_steps(model, tp.tensor_parallel(model, parallel.get_mesh(2, 2, "cuda")),
                           seed, dev, topk=log.record)
        del model
        torch.cuda.empty_cache()
        if dist.get_rank() == 0:
            want = _multi_steps(_multi_model(kind, seed, dev), None, seed, dev,
                                topk=log.replay(len(log.routes)))
            errs = sorted(((norm_err(got["grads"][k], g), k) for k, g in want["grads"].items()
                           if g.abs().max() > 0), reverse=True)
            out_tp[kind] = dict(loss=got["loss"], ref_loss=want["loss"],
                                loss_err=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
                                grad_err=errs[0][0], worst=errs[:3], counts=got["counts"],
                                total=got["total"], ref_counts=want["counts"],
                                step_ms=got["step_ms"], ref_step_ms=want["step_ms"],
                                peak_gib=got["peak_gib"])
            del want
        del got
        torch.cuda.empty_cache()
        dist.barrier()
    return dict(tp=out_tp, study=_sharded_study(seed, root, out, dev))


def phase_two_ranks_tp_study(dev: torch.device, seed: int, tmp: Path, card: str
                             ) -> tuple[dict, dict]:
    """Phase 31: two ranks on the one card over gloo (CUDA tensors). (a)
    AST-MoE (full width and depth, ragged, remat attn_res, dropout 0.1)
    with tensor parallelism 2: each rank holds half of every expert's
    hidden units (K4a at n = F/2, K4b at k = F/2) and half the heads; 2
    steps at batch ``MULTI_BATCH``, step 1's loss and gathered gradients
    against the one-process step on the TP run's routes, in f32
    (``STEP_F32_GRAD``: the split changes the summation order only) and in
    bf16 (``STEP_BF16_GRAD``: each rank's partial expert output is rounded
    to bf16 before the sum, one rounding more than in one process; a router
    weight's gradient, a cancelling sum, and the LayerNorm weight before it
    read 3.6e-2 of their largest in the first run, above phase 29's 2e-2),
    the launches per rank per step. (b) The sharded vmapped study
    (``_sharded_study``, K ``VM_K`` = 2 a rank) against the same study in
    one process: the trials' hyperparameters equal, each trial's accuracies
    within one validation sample, its parameters within ``SHARD_PARAM_ERR``
    (bit-equal when the card's batched products do not depend on the batch
    count; printed). It measures no interconnect. Returns the launches of
    rank 0's TP steps and of its share of the study."""
    from dlsc_tpu_torch.parallel.mesh import spawn

    out = tmp / "sharded"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    ranks = spawn(_phase31_rank, 2, seed, str(tmp / "data"), str(out), backend="gloo",
                  device_type="cuda", device_ids=[0, 0], timeout_s=900)
    ranks_s = time.perf_counter() - t0
    for kind, (name, loss_tol, grad_tol) in (("ast_moe_f32", ("f32", STEP_F32_LOSS, STEP_F32_GRAD)),
                                             ("ast_moe", ("bf16", STEP_BF16_LOSS, STEP_BF16_GRAD))):
        r = ranks[0]["tp"][kind]
        print(f"two ranks on one card, AST-MoE tensor parallel 2 (gloo, ragged, {name}, batch "
              f"{MULTI_BATCH}, K4a/K4b at F/2 = {MOE_FF // 2}): loss {r['loss']:.6f} vs one "
              f"process {r['ref_loss']:.6f} on the same routes (rel {r['loss_err']:.2e}, <= "
              f"{loss_tol}); gradients {r['grad_err']:.3e} (<= {grad_tol}; largest "
              f"{', '.join(f'{k} {e:.1e}' for e, k in r['worst'])}); launches per rank per step "
              f"{r['counts']} (one process {r['ref_counts']}); step 2 {r['step_ms']:.1f} ms vs "
              f"{r['ref_step_ms']:.1f} ms one process; peak {r['peak_gib']:.2f} GiB a rank  "
              f"[{card}]", flush=True)
        require(r["loss_err"] <= loss_tol and r["grad_err"] <= grad_tol,
                f"phase 31: the {name} TP step differs from the one-process step")
        require(r["counts"] == r["ref_counts"] == _counts(
            k1=1, k2f=DEPTH, k2b=DEPTH, gmm=6 * DEPTH, tgmm=2 * DEPTH, drop=_draws(DEPTH, True)),
            f"phase 31 TP launches per rank per step {r['counts']}, one process "
            f"{r['ref_counts']}")

    # --- the sharded study against one process ------------------------------------
    one = _sharded_study(seed, str(tmp / "data"), str(out), dev)
    two = [rk["study"] for rk in ranks]
    lead = two[0]
    n_val = SHARD_VAL * SHARD_BATCH
    acc_gap = max(abs(a - b) for h1, h2 in zip(lead["history"], one["history"])
                  for key in ("val_acc", "train_acc") for a, b in zip(h1[key], h2[key]))
    worst, bitwise = 0.0, True
    for slot in range(VM_K):
        a = torch.load(out / f"two-slot{slot}.pt")
        b = torch.load(out / f"one-slot{slot}.pt")
        bitwise &= torch.equal(a, b)
        worst = max(worst, _rel_err(a, b))
    per_step = {k: v / SHARD_TRAIN for k, v in lead["counts"].items()}
    print(f"sharded vmapped study on two ranks of one card (AST-Base bf16 ln_fused, K {VM_K} = "
          f"2 a rank, per-trial dropout and mixup α, {SHARD_TRAIN} steps at batch {SHARD_BATCH} "
          f"a trial, {SHARD_VAL} val batches): trials {lead['numbers']} as one process "
          f"{one['numbers']}; params equal {lead['params'] == one['params']}; accuracies "
          f"{[h['val_acc'] for h in lead['history']]} vs {[h['val_acc'] for h in one['history']]} "
          f"(largest gap {acc_gap:.4f}, <= {1 / n_val:.4f}); parameters bit-equal {bitwise}, "
          f"largest normalised difference {worst:.3e} (<= {SHARD_PARAM_ERR}); rank 0's launches "
          f"{lead['counts']} ({per_step} a step and its eval); {lead['seconds']:.1f} s on two "
          f"ranks vs {one['seconds']:.1f} s one process (peak {lead['peak_gib']:.2f} vs "
          f"{one['peak_gib']:.2f} GiB); phase 31's ranks {ranks_s:.1f} s  [{card}]", flush=True)
    require(lead["numbers"] == one["numbers"] and lead["params"] == one["params"]
            and all(rk["numbers"] == one["numbers"] for rk in two),
            "phase 31: the sharded study's trials differ from one process's")
    require(acc_gap <= 1 / n_val + 1e-9 and worst <= SHARD_PARAM_ERR,
            f"phase 31: sharded study accuracies (gap {acc_gap}) or parameters ({worst})")
    steps, evals = SHARD_TRAIN, SHARD_VAL
    require(lead["counts"] == _counts(k1=steps + evals, k2f=DEPTH * (steps + evals),
                                      k2b=DEPTH * steps, k3f=DEPTH * 2 * (steps + evals),
                                      k3b=DEPTH * 2 * steps, drop=_draws(DEPTH, False) * steps),
            f"phase 31 sharded study launches {lead['counts']}")
    return r["total"], lead["counts"]   # the bf16 TP run's


def moe_parity_sweep(dev: torch.device, seeds: str, card: str, fault: str | None = None
                     ) -> None:
    """Phase 11 at each seed of ``seeds`` ("A-B"), every reading kept, with
    ``fault`` planted in the bf16 kernels' run if given: a failing seed is
    recorded and the sweep goes on; raises at the end if any seed failed
    (with a fault planted, that is what the gate should do)."""
    first, last = (int(x) for x in seeds.split("-"))
    rows = []
    for seed in range(first, last + 1):
        readings, error = {}, None
        try:
            phase_moe_parity(dev, seed, readings, fault)
        except RuntimeError as e:
            error = str(e)
        rows.append(dict(seed=seed, passed=error is None, error=error, **readings))
        torch.cuda.empty_cache()
    print(json.dumps({"moe_parity_sweep": rows, "fault": fault, "card": card}), flush=True)
    failed = [r["seed"] for r in rows if not r["passed"]]
    require(not failed, f"phase 11 failed at seeds {failed}"
            + (f" with {fault} planted" if fault else ""))


def _clock(phase: int | str, fn, *args):
    """``fn(*args)``, then the phase's seconds printed and the allocator's
    cache emptied."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {phase}: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--moe-parity-seeds", default=None, metavar="A-B",
                    help="run only phase 11 (after the build), once for each seed of A..B, "
                         "and print its readings by seed; fails if any seed fails")
    ap.add_argument("--moe-parity-fault", default=None, choices=MOE_PARITY_FAULTS,
                    help="with --moe-parity-seeds: plant this fault in the bf16 kernels' "
                         "run, a negative control of phase 11's gate")
    ap.add_argument("--multi-device", action="store_true",
                    help="run only phases 29, 30 and 31 (after the build, on their own "
                         "copy of phase 18's shards)")
    args = ap.parse_args()
    if args.moe_parity_fault and args.moe_parity_seeds is None:
        ap.error("--moe-parity-fault needs --moe-parity-seeds")

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
    names = ("mel_power", "attn_fwd", "attn_bwd", "gmm", "ln_fused", "dropout_draw")
    _kernels.build(*names)   # one nvcc per source, all started together
    for name in names:
        _kernels.load(name)
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc: {', '.join(f'{k} {v:.2f} s' for k, v in _kernels.build_seconds.items())}) "
          f"torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    peak_tflops(torch.cuda.get_device_name(dev))   # the MFU needs a known card: fail early
    if args.moe_parity_seeds is not None:
        moe_parity_sweep(dev, args.moe_parity_seeds, card, args.moe_parity_fault)
        return
    if args.multi_device:
        from dlsc_tpu_torch.data.synthetic import make_synthetic_dataset

        with tempfile.TemporaryDirectory() as tmp:
            make_synthetic_dataset(Path(tmp) / "data", num_classes=TRAINER_CLASSES,
                                   clips_per_class_per_fold=TRAINER_CLIPS, n_folds=TRAINER_FOLDS,
                                   clip_samples=CLIP, seed=args.seed)
            _clock(29, phase_multi_device, dev, args.seed, Path(tmp), card)
            _clock(30, phase_two_ranks_one_card, dev, args.seed, card)
            _clock(31, phase_two_ranks_tp_study, dev, args.seed, Path(tmp), card)
        return

    gen = torch.Generator().manual_seed(args.seed)
    seed = args.seed
    k1 = _clock(1, phase_mel, dev, gen)
    k2f = _clock(2, phase_attn, dev, gen)
    k2b = _clock(3, phase_attn_bwd, dev, gen)
    with tempfile.TemporaryDirectory() as tmp:
        serve = _clock(4, phase_slice, dev, seed, Path(tmp), card)
    train, bench_rec = _clock(5, phase_train, dev, seed, card)
    _clock(6, phase_parity, dev, seed)
    k2_moe = _clock(7, phase_attn_ast_moe, dev, gen)
    k4a, k4b = _clock(8, phase_gmm, dev, gen, seed)
    with tempfile.TemporaryDirectory() as tmp:
        moe_serve = _clock(9, phase_moe_slice, dev, seed, Path(tmp), card)
    moe_train, moe_train_run = _clock(10, phase_moe_train, dev, seed, card)
    draw = _clock("10b", phase_draw, dev, gen)
    _clock(11, phase_moe_parity, dev, seed)
    k3f, k3b = _clock(12, phase_ln, dev, gen)
    k5_k6 = _clock(13, phase_attn_k5_k6, dev, gen)
    with tempfile.TemporaryDirectory() as tmp:
        small_serve = _clock(14, phase_small_slice, dev, seed, Path(tmp), card)
    small_train = _clock(15, phase_small_train, dev, seed, card, bench_rec["step_ms"])
    _clock(16, phase_small_parity, dev, seed)
    with tempfile.TemporaryDirectory() as tmp:
        mini_serve, mini_train = _clock(17, phase_mini, dev, seed, Path(tmp), card)
    with tempfile.TemporaryDirectory() as trainer_tmp:   # phase 18's shards serve 23 and 27
        trainer_tmp = Path(trainer_tmp)
        trainer_run = _clock(18, phase_trainer, dev, seed, trainer_tmp, card, bench_rec["value"])
        _clock(19, phase_families_vs_cpu, dev, seed, card)
        fam_train, _ = _clock(20, phase_family_train, dev, seed, card)
        _clock(21, phase_family_parity, dev, seed)
        with tempfile.TemporaryDirectory() as tmp:
            fam_serve, _ = _clock(22, phase_family_serving, dev, seed, Path(tmp), card)
        envnet_trainer = _clock(23, phase_envnet_trainer, dev, seed, trainer_tmp, card)
        remat_runs = _clock(24, phase_remat, dev, seed, card)
        with tempfile.TemporaryDirectory() as tmp:
            import_serve = _clock(25, phase_import_int8, dev, seed, Path(tmp), card)
        lowering_runs = _clock(26, phase_moe_lowerings, dev, seed, card,
                               moe_train_run["record"])
        hpo_run = _clock(27, phase_hpo, dev, seed, trainer_tmp, card)
        vm_run = _clock(28, phase_vmapped_hpo, dev, seed, trainer_tmp, card, gen)
        multi_run = _clock(29, phase_multi_device, dev, seed, trainer_tmp, card)
        one_card_run = _clock(30, phase_two_ranks_one_card, dev, seed, card)
        tp_moe_run, sharded_run = _clock(31, phase_two_ranks_tp_study, dev, seed, trainer_tmp,
                                         card)

    # launches: the training runs' (ast_trainer, envnet_v2_trainer: the train
    # CLI's fit, its validation and its test); launches_serving: the serving runs';
    # launches_by_path: each main path's run, counted from 0 (ast_mini: its
    # served batch and its 2 train steps)
    train_runs = dict(ast_train=train, ast_moe_train=moe_train, ast_small_train=small_train,
                      ast_mini_train=mini_train, ast_trainer=trainer_run,
                      **{f"{k}_train": c for k, c in fam_train.items()},
                      envnet_v2_trainer=envnet_trainer, ast_remat_train=remat_runs,
                      **lowering_runs, hpo_study=hpo_run, hpo_vmapped=vm_run,
                      multi_device_ddp=multi_run, two_ranks_one_card=one_card_run,
                      two_ranks_tp_moe=tp_moe_run, hpo_vmapped_sharded=sharded_run)
    serve_runs = dict(ast_serve=serve, ast_moe_serve=moe_serve, ast_small_serve=small_serve,
                      ast_mini_serve=mini_serve, **{f"{k}_serve": c for k, c in fam_serve.items()},
                      ast_import_int8_serve=import_serve)

    def launches(key):
        by_path = {p: c[key] for p, c in {**train_runs, **serve_runs}.items()}
        by_path["ast_mini"] = by_path.pop("ast_mini_train") + by_path.pop("ast_mini_serve")
        return dict(launches=sum(c[key] for c in train_runs.values()),
                    launches_serving=sum(c[key] for c in serve_runs.values()),
                    launches_by_path=by_path)

    def k5_k6_shapes(part):
        return {shape: c[part] for shape, c in k5_k6.items()}

    kernels = [
        dict(name="mel_power", route="cuda", source="dlsc_tpu_torch/csrc/mel_power.cu",
             replaces="dlsc_tpu/ops/mel_pallas.py:77", **launches("k1"), **k1),
        dict(name="attn_fwd", route="cuda", source="dlsc_tpu_torch/csrc/attn_fwd.cu",
             replaces="dlsc_tpu/ops/attn_fast.py:125, dlsc_tpu/models/vit.py:349, "
                      "dlsc_tpu/models/vit.py:518", **launches("k2f"), **k2f,
             ms_ast_moe=k2_moe["fwd_ms"], graph_ms_ast_moe=k2_moe["fwd_graph_ms"],
             max_abs_err_ast_moe=k2_moe["fwd_err"],
             k5_k6_shapes=k5_k6_shapes("fwd")),
        dict(name="attn_bwd", route="cuda", source="dlsc_tpu_torch/csrc/attn_bwd.cu",
             replaces="dlsc_tpu/ops/attn_fast.py:205, dlsc_tpu/models/vit.py:349, "
                      "dlsc_tpu/models/vit.py:518", **launches("k2b"), **k2b,
             ms_ast_moe=k2_moe["bwd_ms"], graph_ms_ast_moe=k2_moe["bwd_graph_ms"],
             max_abs_err_ast_moe=k2_moe["bwd_err"], k5_k6_shapes=k5_k6_shapes("bwd")),
        dict(name="gmm", route="cuda", source="dlsc_tpu_torch/csrc/gmm.cu",
             replaces="dlsc_tpu/models/moe.py:537", **launches("gmm"), **k4a),
        dict(name="tgmm", route="cuda", source="dlsc_tpu_torch/csrc/gmm.cu",
             replaces="jax/experimental/pallas/ops/tpu/megablox/gmm.py:573",
             **launches("tgmm"), **k4b),
        dict(name="add_ln_fwd", route="cuda", source="dlsc_tpu_torch/csrc/ln_fused.cu",
             replaces="dlsc_tpu/ops/ln_fused.py:53", **launches("k3f"), **k3f),
        dict(name="add_ln_bwd", route="cuda", source="dlsc_tpu_torch/csrc/ln_fused.cu",
             replaces="dlsc_tpu/ops/ln_fused.py:93", **launches("k3b"), **k3b),
        dict(name="dropout_draw", route="cuda", source="dlsc_tpu_torch/csrc/dropout_draw.cu",
             replaces="none: the dropout masks that jax.random draws in XLA "
                      "(dlsc_tpu/models/moe.py:437, dlsc_tpu/models/vit.py:582)",
             **launches("drop"), **{k: v for k, v in draw.items() if k != "build"}),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
