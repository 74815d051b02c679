"""Train-step throughput of one of the port's models on one GPU.

    python -m dlsc_tpu_torch.scripts.bench [--model ast|ast_moe|ast_small|ast_mini] \
        [--ln-fused] [--batch 64] [--steps 10] [--warmup 2] [--seed 0]
    python -m dlsc_tpu_torch.scripts.bench --model ast_moe [--router token|expert] \
        [--dispatch ragged|einsum|scatter]
    python -m dlsc_tpu_torch.scripts.bench --model envnet_v2|cnn_esc50|leaf

The configuration of the root ``bench.py`` (``bench.py:49-73``): AST-Base
(``configs/model/ast.yaml``) in bf16 with remat ``attn_res``, seeded random
weights; SpecAugment (time 192, freq 48) and Mixup (alpha 0.5); soft-label
cross-entropy; Adam lr 5e-4, weight decay 1e-6, cosine T_max 100 over 25
steps per epoch, global-norm clip 1.0; a batch of 64 synthetic 5-s clips
(220 500 samples at 44.1 kHz). The step is ``train/steps.py``'s, through
kernels K1, K2f and K2b. ``--model ast_moe`` runs AST-MoE
(``configs/model/ast_moe.yaml``, ``ASTMoE``'s defaults: bf16, remat
``attn_res``, dropout 0.1; 8 experts, top-2, dropless ragged dispatch) with
the same pipeline and optimizer, since the two configs' dataset overrides
are the same; its experts run on kernels K4a and K4b. ``--router`` and
``--dispatch`` choose its routing and dispatch as ``model.router`` and
``model.dispatch`` do (``scripts/bench_moe.py``'s dispatch A/B, taken at the
whole train step): the capacity dispatches ``einsum`` and ``scatter``
(capacity factor 1.25, groups of 256 tokens) run the experts as batched
products, without K4; ``--router expert`` with the default dispatch runs on
``einsum``, as ``ASTMoE`` rewrites it. ``--model ast_small``
(``configs/model/ast_small.yaml``: patch 16, stride 16; ``ASTViTSmall``'s
defaults: bf16, remat ``attn_res``, dropout 0.1) and ``--model ast_mini``
(``configs/model/ast_mini.yaml``: stride 10; ``ASTMiniViT``'s defaults:
bf16, no remat, dropout 0.1) run the same way, their dataset overrides
being the same too. ``--ln-fused`` builds the model with ``ln_fused``: each
block's attention residual add and norm2 run on kernels K3f and K3b.

``--model envnet_v2``, ``cnn_esc50`` and ``leaf`` run the other families
in their configs' precision (f32) with their configs' pipelines and
``configs/base_training.yaml``'s recipe (Adam lr 1e-4, weight decay 1e-4,
cosine over 250 epochs, clip 1.0): EnvNet-v2 on pad + random crop + BC
mixing with ``KLDivLoss`` (batchmean); the CNN on kernel K1 at 1024/512/1024
+ dB + the 224² resize + flips and translation, cross-entropy; LEAF (128
Gabor filters of 401 taps, ``configs/model/leaf.yaml``) on pad + random
crop, cross-entropy. Their ``mfu`` and ``hw_util`` are null: the JAX package
counts FLOPs only for the ViT family.

Prints one JSON line: ``metric``, ``value`` (clips/s), ``unit``, ``batch``,
``step_ms`` (host clock over ``--steps`` steps ending in a synchronize,
after ``--warmup`` steps), ``mfu`` and ``hw_util`` (``utils/mfu.py`` over
the card's bf16 peak), ``device``, ``n_chips``, the peak device memory,
``profile`` (two more steps under ``torch.profiler``: device ms per step by
kind of kernel, the top kernels, the busy share) and ``decomp``, read from
that profile: the attention kernels K2f and K2b per step (depth launches
each), for AST-MoE the grouped-matmul kernels K4a and K4b, with
``--ln-fused`` the add + LayerNorm kernels K3f and K3b, and the rest of the
step. The FLOP convention is the useful count of ``utils/mfu.py``:
4·n²·D forward and 10·n²·D backward at n_real for attention; an MoE block
counts top_k × its two expert products per real token plus the router.
K3 adds no matmul FLOPs (nor do the capacity dispatches' one-hot products
and empty slots: the count stays the useful one). An MoE record also holds
``moe/drop_frac`` and ``moe/util``, the timed steps' means. A fixed batch
runs or raises: no back-off.
"""

from __future__ import annotations

import argparse
import json
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
from dlsc_tpu_torch.models.moe import MOE_METRICS
from dlsc_tpu_torch.models.vit import ASTViT
from dlsc_tpu_torch.train.losses import CrossEntropyLoss, KLDivLoss
from dlsc_tpu_torch.train.metrics import MetricState
from dlsc_tpu_torch.train.optim import adam, cosine_annealing
from dlsc_tpu_torch.train.state import TrainState
from dlsc_tpu_torch.train.steps import make_train_step
from dlsc_tpu_torch.utils.mfu import ast_step_flops, ast_token_counts, peak_tflops

# configs/model/ast.yaml, written out: the card's machine may lack pyyaml.
AST_BASE = dict(num_classes=50, sample_rate=44_100, patch_size=16, patch_stride=10,
                overlap=6, pretrained_model="deit_base_patch16_384")
# configs/model/ast_moe.yaml, written out
AST_MOE = dict(num_classes=50, sample_rate=44_100, patch_size=16, patch_stride=16, overlap=0,
               n_experts=8, top_k=2, capacity_factor=1.25, aux_weight=0.01,
               router_z_weight=0.001, router="token", dispatch="ragged", group_size=256)
# configs/model/ast_small.yaml and ast_mini.yaml, written out
AST_SMALL = dict(num_classes=50, sample_rate=44_100, patch_size=16, patch_stride=16, overlap=0)
AST_MINI = dict(num_classes=50, sample_rate=44_100, patch_size=16, patch_stride=10, overlap=6)
# configs/model/envnet_v2.yaml, cnn_esc50.yaml and leaf.yaml, written out
ENVNET = dict(num_classes=50, dropout=0.5)
CNN = dict(num_classes=50)
LEAF = dict(num_classes=50, n_filters=128, kernel_size=401, sample_rate=44_100)
FAMILIES = ("envnet_v2", "cnn_esc50", "leaf")   # BatchNorm models, f32
CLIP = 220_500
FLOP_CONVENTION = ("useful FLOPs (utils/mfu.py): parameter matmuls x3, attention "
                   "4·n²·D forward + 10·n²·D backward, at n_real tokens")
MOE_FLOP_CONVENTION = ("; an MoE block: top_k x the two expert products (2·D·F each) per "
                       "real token plus the router (2·D·E), x3")
METRICS = {
    "ast": "AST-Base train-step throughput (K1 mel + SpecAugment + Mixup + ViT-Base bf16 "
           "fwd/bwd, remat attn_res, + Adam), 5-s clips",
    "ast_moe": "AST-MoE train-step throughput (K1 mel + SpecAugment + Mixup + AST-Small "
               "trunk with 8-expert top-2 MoE MLPs, dropless ragged dispatch on K4a/K4b, bf16 "
               "fwd/bwd, dropout 0.1, remat attn_res, + Adam), 5-s clips",
    "ast_small": "AST-Small train-step throughput (K1 mel + SpecAugment + Mixup + ViT 384/12/6 "
                 "patch 16 stride 16, bf16 fwd/bwd, dropout 0.1, remat attn_res, + Adam), "
                 "5-s clips",
    "ast_mini": "AST-Mini train-step throughput (K1 mel + SpecAugment + Mixup + ViT 192/6/3 "
                "patch 16 stride 10, bf16 fwd/bwd, dropout 0.1, no remat, + Adam), 5-s clips",
    "envnet_v2": "EnvNet-v2 train-step throughput (pad + random crop + BC mixing + KLDiv, f32 "
                 "fwd/bwd, BatchNorm, dropout 0.5, + Adam), 5-s clips",
    "cnn_esc50": "spectrogram-CNN train-step throughput (K1 mel 1024/512/1024 + dB + 224² "
                 "resize + flips/translate, f32 fwd/bwd, BatchNorm, dropout 0.5, + Adam), 5-s "
                 "clips",
    "leaf": "LEAF train-step throughput (pad + random crop, Gabor conv 128 x 401 + PCEN + 1-D "
            "CNN, f32 fwd/bwd, BatchNorm, dropout 0.3, + Adam), 5-s clips",
}
LN_FUSED_NOTE = "; K3 fused residual add + LayerNorm in every block"
K2F, K2B = "K2f attention forward", "K2b attention backward"
K3F, K3B = "K3f add+LN forward", "K3b add+LN backward"
K4A, K4B = "K4a gmm", "K4b tgmm"

# Device-kernel name fragments → the layer they belong to, first match wins.
_KERNEL_KINDS = (
    (K2F, ("attn_fwd",)),
    (K2B, ("attn_bwd",)),
    (K3F, ("add_ln_fwd",)),
    (K3B, ("add_ln_bwd",)),
    (K4B, ("tgmm",)),
    (K4A, ("gmm",)),
    ("K1 mel", ("mel_power",)),
    ("BatchNorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("pooling", ("max_pool", "avg_pool", "MaxPool", "AvgPool", "pooling")),
    ("convolutions (cuDNN)", ("conv", "cudnn", "dgrad", "wgrad", "fprop")),
    ("GEMM (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "sm90_")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("optimizer", ("multi_tensor", "adam", "Adam")),
    ("routing sort", ("Radix", "radix", "Sort", "sort")),
    ("copies and casts", ("copy", "Copy", "CatArray", "cat_")),
    ("reductions", ("reduce", "Reduce")),
    ("other elementwise", ("elementwise", "vectorized", "unrolled")),
)


def bench_pipeline() -> DevicePipeline:
    return DevicePipeline(PipelineConfig(mode="ast", num_classes=AST_BASE["num_classes"],
                                         time_mask=192, freq_mask=48, enable_mixup=True,
                                         mixup_alpha=0.5))


def family_pipeline(model_name: str) -> DevicePipeline:
    """The configs' pipeline of a CNN family: EnvNet-v2's BC mixing, the
    CNN's images, LEAF's padded crops."""
    if model_name == "cnn_esc50":
        return DevicePipeline(PipelineConfig(mode="cnn_esc50", num_classes=CNN["num_classes"]))
    return DevicePipeline(PipelineConfig(mode="envnet_v2", num_classes=ENVNET["num_classes"],
                                         enable_bc_mixing=model_name == "envnet_v2"))


def build_model(model_name: str, seed: int, device: torch.device, ln_fused: bool = False,
                remat_policy: str | None = None, moe: dict | None = None):
    """The bench's ``model_name`` (a key of ``METRICS``) with seeded weights,
    under ``remat_policy`` when given (the AST models with remat); ``moe``
    overrides AST-MoE's ``router`` and ``dispatch``."""
    gen = torch.Generator().manual_seed(seed)
    if remat_policy is not None and model_name in (*FAMILIES, "ast_mini"):
        raise ValueError(f"{model_name} has no remat")
    if model_name == "envnet_v2":
        return EnvNetV2(**ENVNET, generator=gen, device=device)
    if model_name == "cnn_esc50":
        return CNN_ESC50(**CNN, generator=gen, device=device)
    if model_name == "leaf":
        return LeafModel(**LEAF, generator=gen, device=device)
    kw = dict(ln_fused=ln_fused, generator=gen, device=device)
    remat = dict(remat=True, remat_policy=remat_policy or "attn_res")
    if model_name == "ast":
        return ASTModel(**AST_BASE, dtype=torch.bfloat16, **remat, **kw)
    if model_name == "ast_moe":
        return ASTMoE(**{**AST_MOE, **(moe or {})}, **remat, **kw)
    if model_name == "ast_small":
        return ASTViTSmall(**AST_SMALL, **remat, **kw)
    if model_name == "ast_mini":
        return ASTMiniViT(**AST_MINI, **kw)
    raise ValueError(f"unknown bench model {model_name!r}; known: {sorted(METRICS)}")


def build(batch: int, seed: int, device: torch.device, model_name: str = "ast",
          ln_fused: bool = False, remat_policy: str | None = None, moe: dict | None = None):
    """(train_step, state, metric state, waves, labels) of the bench on
    ``device`` for ``model_name`` (a key of ``METRICS``)."""
    model = build_model(model_name, seed, device, ln_fused, remat_policy, moe)
    extras = MOE_METRICS if model.config.get("moe") else ()
    if model_name in FAMILIES:   # configs/base_training.yaml's recipe
        state = TrainState.create(model, adam(lr=1e-4, weight_decay=1e-4),
                                  cosine_annealing(T_max=250), steps_per_epoch=25,
                                  gradient_clip_val=1.0, seed=seed)
        criterion = KLDivLoss() if model_name == "envnet_v2" else CrossEntropyLoss()
        step = make_train_step(family_pipeline(model_name), criterion)
    else:
        state = TrainState.create(model, adam(lr=5e-4, weight_decay=1e-6),
                                  cosine_annealing(T_max=100), steps_per_epoch=25,
                                  gradient_clip_val=1.0, seed=seed)
        step = make_train_step(bench_pipeline(), CrossEntropyLoss())
    rng = np.random.default_rng(seed)
    wave = torch.from_numpy((rng.standard_normal((batch, CLIP)) * 0.3).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, AST_BASE["num_classes"], batch))
    return (step, state, MetricState.create(AST_BASE["num_classes"], device, extras),
            wave.to(device), labels.to(device))


def _metric_key(model: torch.nn.Module) -> str:
    """The ``METRICS`` key of a bench model."""
    family = {EnvNetV2: "envnet_v2", CNN_ESC50: "cnn_esc50", LeafModel: "leaf"}
    if type(model) in family:
        return family[type(model)]
    if model.config["moe"]:
        return "ast_moe"
    return {768: "ast", 384: "ast_small", 192: "ast_mini"}[model.config["emb_dim"]]


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


def profile_calls(fn, n: int = 2, top: int = 15) -> dict:
    """``n`` calls of ``fn`` under ``torch.profiler``: device ms per call by
    kind of kernel, the ``top`` kernels, kernels launched per call, the
    device's busy share of the profiled wall time (the profiler slows the
    host, so the share is a lower bound), and the host ops with the most
    self CPU time (where a host-bound call spends its wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    n_kernels = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
            n_kernels += 1
    kinds: dict[str, float] = {}
    for name, t in by_name.items():
        kind = next((k for k, frags in _KERNEL_KINDS if any(f in name for f in frags)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + t / n
    busy = sum(by_name.values())
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / n, e.count / n)
                   for e in prof.key_averages()), key=lambda kv: -kv[1])[:top]
    return {
        "calls": n,
        "device_ms_per_call": busy / n,
        "wall_ms_per_call": wall_ms / n,
        "busy_share": busy / wall_ms,
        "kernels_per_call": n_kernels / n,
        "by_kind_ms": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": {name[:90]: t / n for name, t in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:top]},
        "host_self_cpu_ms": {key[:60]: dict(ms=t, calls=c) for key, t, c in host},
    }


def profile_steps(step, state, ms, wave, labels, n: int = 2, top: int = 15) -> dict:
    """``profile_calls`` over ``n`` train steps, its per-call numbers named
    per step."""
    box = [ms]

    def one_step():
        box[0] = step(state, box[0], wave, labels)[1]

    prof = profile_calls(one_step, n, top)
    return {"steps": n, **{k.replace("_per_call", "_per_step"): v for k, v in prof.items()
                           if k != "calls"}}


def record(model: torch.nn.Module, batch: int, step_s: float, losses: np.ndarray,
           peak_mem_gib: float, prof: dict) -> dict:
    """The bench's JSON record from a measured step time and a profile."""
    if not isinstance(model, ASTViT):
        return _family_record(model, batch, step_s, losses, peak_mem_gib, prof)
    cfg = model.config
    n_real, n_pad = ast_token_counts(model, CLIP)
    fl = ast_step_flops(model, n_real, n_pad)
    name = torch.cuda.get_device_name()
    peak = peak_tflops(name) * 1e12
    kinds = prof["by_kind_ms"]
    attn_ms = kinds.get(K2F, 0.0) + kinds.get(K2B, 0.0)
    heads, moe, ln_fused = cfg["num_heads"], cfg["moe"], cfg["ln_fused"]
    note = (f"device ms per step under the profiler: K2f + K2b, {cfg['depth']} launches each "
            f"at (B {batch}, H {heads}, N {n_pad}, dh {cfg['emb_dim'] // heads}) "
            f"{cfg['dtype']}, n_real {n_real}")
    decomp = {"attn_fwd_ms": kinds.get(K2F, 0.0), "attn_bwd_ms": kinds.get(K2B, 0.0),
              "attn_ms": attn_ms}
    kernel_ms = attn_ms
    metric = METRICS[_metric_key(model)]
    if moe and moe["dispatch"] != "ragged":
        metric = metric.replace("dropless ragged dispatch on K4a/K4b", (
            f"{moe['router']}-choice routing on the {moe['dispatch']} capacity dispatch, "
            f"capacity factor {moe['capacity_factor']}, groups of {moe['group_size']}"))
    elif moe:
        decomp.update(gmm_ms=kinds.get(K4A, 0.0), tgmm_ms=kinds.get(K4B, 0.0))
        kernel_ms += decomp["gmm_ms"] + decomp["tgmm_ms"]
        m_rows = batch * n_real * moe["top_k"]
        note += (f"; K4a gmm (forward, remat re-forward, dlhs) and K4b tgmm at {m_rows} "
                 f"sorted rows over {moe['n_experts']} experts")
    if ln_fused:
        decomp.update(ln_fwd_ms=kinds.get(K3F, 0.0), ln_bwd_ms=kinds.get(K3B, 0.0))
        kernel_ms += decomp["ln_fwd_ms"] + decomp["ln_bwd_ms"]
        note += (f"; K3f (forward{', remat re-forward' if cfg['remat'] else ''}) and K3b at "
                 f"({batch * n_pad}, {cfg['emb_dim']}) {cfg['dtype']}")
    decomp["rest_ms"] = prof["device_ms_per_step"] - kernel_ms
    decomp["note"] = note + "; rest = the other kernels"
    return {
        "metric": metric + (LN_FUSED_NOTE if ln_fused else ""),
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
        "flop_convention": FLOP_CONVENTION + (MOE_FLOP_CONVENTION if moe else ""),
        "decomp": decomp,
        "profile": prof,
    }



def _family_record(model: torch.nn.Module, batch: int, step_s: float, losses: np.ndarray,
                   peak_mem_gib: float, prof: dict) -> dict:
    """A CNN family's record: no FLOP count (``mfu`` null), and the step's
    device time by kind from the profile."""
    kinds = prof["by_kind_ms"]
    return {
        "metric": METRICS[_metric_key(model)],
        "value": batch / step_s,
        "unit": "clips/s",
        "batch": batch,
        "step_ms": step_s * 1e3,
        "mfu": None,
        "hw_util": None,
        "device": torch.cuda.get_device_name(),
        "n_chips": 1,
        "peak_mem_gib": peak_mem_gib,
        "losses": losses.tolist(),
        "decomp": {"k1_ms": kinds.get("K1 mel", 0.0),
                   "conv_ms": kinds.get("convolutions (cuDNN)", 0.0),
                   "rest_ms": prof["device_ms_per_step"] - kinds.get("K1 mel", 0.0)
                   - kinds.get("convolutions (cuDNN)", 0.0),
                   "note": "device ms per step under the profiler: K1 (the CNN's front end), "
                           "cuDNN convolutions, and the other kernels"},
        "profile": prof,
    }


def measure(batch: int = 64, steps: int = 10, warmup: int = 2, seed: int = 0,
            model_name: str = "ast", ln_fused: bool = False, moe: dict | None = None) -> dict:
    """Run the bench and return its JSON record (see the module docstring)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the bench needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    step, state, ms, wave, labels = build(batch, seed, dev, model_name, ln_fused, moe=moe)
    torch.cuda.reset_peak_memory_stats(dev)
    state, ms, losses, step_s = timed_steps(step, state, ms, wave, labels, warmup, steps)
    peak_mem = torch.cuda.max_memory_allocated(dev) / 2**30
    stats = {k: float(v) for k, v in ms.extra_means().items()}
    prof = profile_steps(step, state, ms, wave, labels)
    return {**record(state.model, batch, step_s, losses, peak_mem, prof), **stats}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(METRICS), default="ast")
    ap.add_argument("--ln-fused", action="store_true",
                    help="fused residual add + LayerNorm (kernel K3) in every block")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--router", choices=("token", "expert"), default=None,
                    help="AST-MoE's router (default: the config's, token)")
    ap.add_argument("--dispatch", choices=("ragged", "einsum", "scatter"), default=None,
                    help="AST-MoE's dispatch (default: the config's, ragged)")
    args = ap.parse_args(argv)
    if args.ln_fused and args.model in FAMILIES:
        ap.error(f"--ln-fused applies to the AST family, not {args.model}")
    moe = {k: v for k, v in (("router", args.router), ("dispatch", args.dispatch)) if v}
    if moe and args.model != "ast_moe":
        ap.error("--router and --dispatch apply to --model ast_moe")
    rec = measure(args.batch, args.steps, args.warmup, args.seed, args.model, args.ln_fused,
                  moe or None)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
