"""Driver of ``kind: train`` traffic: a closed loop of the port's train step
(``train.steps.make_train_step_indexed``) over a device-resident pool of
clips, one batch after the other, as the Trainer runs it.

Set-up makes the weights, the pool, its labels and the model, optimizer and
step from the seed, then drives that one object through the compared steps
(``compared_steps``: they also warm every shape the window uses) and reads
the program's side of the comparison from it: each step's loss, the first
step's gradient from Adam's first moment, and each unit's change over the
steps. The window then runs the same object for ``--seconds``; a traced run
adds ``profiled_steps`` steps under the profiler. Once the window has
closed and the memory peak is read, the program is freed and the reference
follows the compared steps from the same weights and batches.
"""

from __future__ import annotations

import functools
import gc
import time

import torch

from benchmark import checks, harness, inputs
from benchmark.flops import token_counts
from benchmark.reference import train as ref_train

from dlsc_tpu_torch.data.pipeline import DevicePipeline, PipelineConfig, TrainDraws
from dlsc_tpu_torch.models.moe import MOE_METRICS
from dlsc_tpu_torch.models.vit import ASTViT
from dlsc_tpu_torch.ops.augment import MixupDraws, SpecAugmentDraws
from dlsc_tpu_torch.train.losses import CrossEntropyLoss
from dlsc_tpu_torch.train.metrics import MetricState
from dlsc_tpu_torch.train.optim import adam, cosine_annealing
from dlsc_tpu_torch.train.state import TrainState
from dlsc_tpu_torch.train.steps import make_train_step_indexed

MODEL_KEYS = ("num_classes", "emb_dim", "depth", "num_heads", "patch_size", "patch_stride",
              "overlap", "sample_rate", "f_dim", "dtype", "remat", "remat_policy", "dropout",
              "moe")


def port_model(model: dict, device) -> ASTViT:
    return ASTViT(**{k: model[k] for k in MODEL_KEYS}, device=device)


def port_pipeline(cfg: dict) -> DevicePipeline:
    p = cfg["pipeline"]
    return DevicePipeline(PipelineConfig(
        mode=p["mode"], num_classes=cfg["model"]["num_classes"],
        sample_rate=cfg["model"]["sample_rate"], n_mels=p["n_mels"], normalize=p["normalize"],
        target_mean=p["target_mean"], target_std=p["target_std"], time_mask=p["time_mask"],
        freq_mask=p["freq_mask"], enable_mixup=p["enable_mixup"], mixup_alpha=p["mixup_alpha"]))


def port_draws(d: inputs.Draws) -> TrainDraws:
    t = torch.from_numpy
    return TrainDraws(SpecAugmentDraws(t(d.t_start), t(d.t_len), t(d.f_start), t(d.f_len)),
                      MixupDraws(t(d.gate), t(d.lam), t(d.partner)))


def program_units(model: torch.nn.Module, named: dict[str, torch.Tensor]) -> dict[str, float]:
    return ref_train.unit_norms({n: named[n] for n, _ in model.named_parameters()})


def shapes(cfg: dict, tr: dict) -> dict:
    m = cfg["model"]
    T = int(cfg["clip_seconds"] * m["sample_rate"])
    n_real, n_pad = token_counts(m, T)
    return {"T": T, "frames": 1 + T // 160, "n_real": n_real, "n_pad": n_pad,
            "spe": tr["pool_clips"] // tr["batch"]}


class Program:
    """The port's train step with its model and optimizer state, built from
    the seed and driven through the compared steps; ``call()`` runs the
    next step, ``readings`` holds the program's side of the comparison."""

    def __init__(self, cfg: dict, tr: dict, seed: int, dev, hooks: dict):
        m, opt = cfg["model"], cfg["optimizer"]
        sh = shapes(cfg, tr)
        B, P, C = tr["batch"], tr["pool_clips"], m["num_classes"]
        w0 = inputs.weights(m, seed, dev)
        model = port_model(m, dev)
        model.load_state_dict(w0)
        self.state = TrainState.create(
            model, adam(opt["lr"], opt["weight_decay"], opt["betas"], opt["eps"]),
            cosine_annealing(opt["T_max"]), sh["spe"], opt["gradient_clip_val"],
            seed=inputs.stream(seed, "order"))
        self.step = hooks.get("train_step", lambda s: s)(
            make_train_step_indexed(port_pipeline(cfg), CrossEntropyLoss(),
                                    **hooks.get("ops", {})))
        self.ms = MetricState.create(C, dev, MOE_METRICS if m.get("moe") else ())
        self.pool = inputs.clips(P, sh["T"], m["sample_rate"], seed, dev)
        self.labels = torch.as_tensor(inputs.labels(P, C, seed), device=dev)
        self.cfg, self.tr, self.seed, self.dev, self.sh, self.i = cfg, tr, seed, dev, sh, 0

        params = dict(model.named_parameters())
        moes = [blk.moe for blk in model.blocks if hasattr(blk, "moe")]
        logits: dict[int, torch.Tensor] = {}
        sent: dict[int, torch.Tensor] = {}
        for j, moe in enumerate(moes):   # observe the router; compute nothing of the step
            moe.router_hook = functools.partial(_first, logits, j)
            moe.route_hook = functools.partial(_first, sent, j)
        losses, routes, astray = [], [], 0
        for i in range(tr["compared_steps"]):
            logits.clear()
            sent.clear()
            losses.append(self.call())
            routes.append([_routes(logits[j], sh["n_real"], m["moe"]["top_k"])
                           for j in range(len(moes))])
            astray += sum(_astray(sent[j], r, sh["n_real"]) for j, r in enumerate(routes[-1]))
            if i == 0:
                b1 = opt["betas"][0]
                grad = program_units(model, {n: self.state.optimizer.state[p]["exp_avg"]
                                             / (1 - b1) for n, p in params.items()})
        for moe in moes:
            moe.router_hook = moe.route_hook = None
        change = program_units(model, {n: p.detach() - w0[n] for n, p in params.items()})
        tokens = tr["compared_steps"] * len(moes) * B * sh["n_real"]
        self.readings = {"losses": [float(x) for x in losses], "grad": grad, "change": change,
                         **({"routes": routes, "route_topk_gap": astray / tokens}
                            if moes else {})}

    def call(self) -> torch.Tensor:
        """The next train step through the window's own call; its loss."""
        cfg, tr, i, dev = self.cfg, self.tr, self.i, self.dev
        B, P = tr["batch"], tr["pool_clips"]
        idx = torch.as_tensor(inputs.order(i, P, B, self.seed)).to(dev, non_blocking=True)
        d = inputs.draws(i, B, self.sh["frames"], cfg["pipeline"], self.seed)
        _, self.ms, loss = self.step(self.state, self.ms, self.pool, idx,
                                     self.labels.index_select(0, idx), draws=port_draws(d),
                                     dropout_seed=inputs.dropout_seed(i, self.seed))
        self.i = i + 1
        return loss


def _first(store: dict, j: int, *seen: torch.Tensor) -> None:
    """``MoeMlp.router_hook`` and ``route_hook``: keep what MoE block ``j``
    shows of the step's forward, its router logits or the count of each
    token's dispatches to each expert (the remat re-forward shows the same
    again)."""
    store.setdefault(j, seen[-1].detach())


def _routes(logits: torch.Tensor, n_real: int, k: int) -> torch.Tensor:
    """The top k experts of the program's router gates (the softmax of its
    logits) for the real tokens, as ``models.moe.topk_routes`` chooses."""
    return torch.topk(torch.softmax(logits, -1), k, dim=-1, sorted=True).indices[:, :n_real]


def _astray(sent: torch.Tensor, routes: torch.Tensor, n_real: int) -> int:
    """The real tokens that the program dispatched to other experts than
    the top k of its own gates (``sent``: (B, N, E) dispatch counts)."""
    top = torch.zeros_like(sent[:, :n_real]).scatter_(-1, routes, 1.0)
    return int((sent[:, :n_real] != top).any(-1).sum())


def reference(cfg: dict, tr: dict, seed: int, dev, prec: str = "f32",
              rows: int | None = None, routes: list | None = None,
              follow=ref_train.follow) -> dict:
    """The reference over the compared steps, from inputs made again from
    the seed: the same weights, pool rows, labels, draws and dropout seeds;
    an MoE model replays ``routes`` (the run it judges)."""
    m, sh = cfg["model"], shapes(cfg, tr)
    B, P, C = tr["batch"], tr["pool_clips"], m["num_classes"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pool = inputs.clips(P, sh["T"], m["sample_rate"], seed, dev)
    labels = torch.as_tensor(inputs.labels(P, C, seed), device=dev)
    batches = []
    for i in range(tr["compared_steps"]):
        r = torch.as_tensor(inputs.order(i, P, B, seed), device=dev)
        batches.append((pool[r], torch.nn.functional.one_hot(labels[r], C).float(),
                        inputs.draws(i, B, sh["frames"], cfg["pipeline"], seed),
                        inputs.dropout_seed(i, seed)))
    del pool
    return follow(m, cfg["pipeline"], cfg["optimizer"], m["sample_rate"],
                  inputs.weights(m, seed, dev), batches, sh["spe"], sh["n_real"], sh["n_pad"],
                  prec=prec, rows=rows, routes=routes)


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run(ctx) -> dict:
    cfg, tr, dev, seed = ctx.cell.config, ctx.cell.traffic, ctx.device, ctx.seed
    prog = Program(cfg, tr, seed, dev, ctx.hooks)
    harness.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    setup_peak = harness.peak_bytes(dev, reset=True)

    # ---- the window ---------------------------------------------------------------
    win = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        win.append(prog.call())
    harness.sync(dev)
    window_s = time.perf_counter() - t0
    steps = len(win)
    trace = harness.profile(prog.call, tr["profiled_steps"], dev) if ctx.trace else None
    traced = {} if trace is None else {   # the profiled steps beside the window's
        "traced_busy_ms_per_step": 1e3 * trace.busy_s() / trace.steps,
        "traced_wall_ms_per_step": 1e3 * trace.window_s / trace.steps,
        "window_ms_per_step": 1e3 * window_s / max(steps, 1)}
    peak = harness.peak_bytes(dev)
    failed = int((~torch.isfinite(torch.stack(win))).sum()) if win else 0
    mine = prog.readings
    del prog, win
    free(dev)

    # ---- the reference follows the compared steps -----------------------------------
    t_ref = time.perf_counter()
    ref = reference(cfg, tr, seed, dev, routes=mine.get("routes"),
                    follow=ctx.hooks.get("reference", ref_train.follow))
    readings = checks.train_readings(mine, ref)
    correct, compared = checks.judge(readings, ctx.cell.limits)
    sh = shapes(cfg, tr)
    return {
        "correct": correct and failed == 0,
        "attempted": steps,
        "failed": failed,
        "metrics": {"train_clips_per_s": steps * tr["batch"] / window_s,
                    "peak_mem_gib": peak / 2**30, "setup_s": setup_s},
        "host": {"steps": steps, "window_s": window_s, "batch": tr["batch"],
                 "n_real": sh["n_real"], "n_pad": sh["n_pad"]},
        "trace": trace,
        "checks": compared,
        "memory_peak_bytes": max(peak, setup_peak),
        "log": {"losses": mine["losses"], "reference_losses": ref["losses"],
                "reference_s": time.perf_counter() - t_ref, **traced},
    }
