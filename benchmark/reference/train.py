"""The reference's train steps: the recipe's step written out plainly, from
the same initial weights over the same batches, draws and dropout seeds.

A step: eval features of the clips, SpecAugment, Mixup (no gradient), the
model in blocks of rows (``chunk``; the loss is a mean over the batch, so
each block's loss is its sum over the batch size, and with MoE blocks the
load-balance term takes the whole batch's first-choice shares, counted by a
forward without gradients first), then optax's clip by global norm (scale
by max_norm / norm when norm >= max_norm), L2 weight decay added to the
gradient, and Adam with bias correction at the step's learning rate.

``follow`` returns each step's loss, each unit's norm of the first step's
gradient as Adam receives it (clipped, decay added) and each unit's norm of
the change of its parameters over the steps. A unit is a parameter, the
packed qkv weight and bias split into their q, k and v parts.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import features as feats
from benchmark.reference.vit import Reference, soft_cross_entropy_sum


def units(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The compared units of ``params``: views, qkv split three ways."""
    out = {}
    for n, t in params.items():
        if ".attn.qkv." in n:
            for part, v in zip("qkv", t.chunk(3, 0)):
                out[f"{n}:{part}"] = v
        else:
            out[n] = t
    return out


def unit_norms(params: dict[str, torch.Tensor]) -> dict[str, float]:
    return {n: float(t.detach().double().norm()) for n, t in units(params).items()}


def lr_at(opt: dict, step: int, steps_per_epoch: int) -> float:
    """The cosine schedule over epochs, constant within one."""
    epoch = step // max(steps_per_epoch, 1)
    return 0.5 * opt["lr"] * (1.0 + math.cos(math.pi * epoch / opt["T_max"]))


def chunk_rows(model: dict, n: int, budget: float = 3e9) -> int:
    """Rows a block of the backward holds: its f32 scores (and their
    softmax and gradient) within ``budget`` bytes."""
    per_row = 3 * 4 * model["num_heads"] * n * n
    return max(1, int(budget // per_row))


def step_grads(ref: Reference, x: torch.Tensor, y: torch.Tensor, seed: int | None,
               rows: int, chunk: int, routes: list | None) -> dict:
    """The step on the first ``rows`` rows of (x, y), ``chunk`` rows at a
    time; gradients accumulate on ``ref.p``. Returns its loss and, with MoE
    blocks, the routes taken (``routes`` replayed where given) and how many
    of the replayed ones differ from the model's own choice."""
    x, y = x[:rows], y[:rows]
    out = {"loss": 0.0}
    n_tok = fracs = None
    if ref.moe:   # the whole batch's first-choice shares, per block, and its routes
        with torch.no_grad():
            infos = [ref.forward(x[a:a + chunk], a, seed, remat=False, routes=routes)[2]
                     for a in range(0, rows, chunk)]
        counts = torch.stack([sum(inf[i][0] for inf in infos) for i in range(len(infos[0]))])
        fracs = list((counts.float() / counts[0].sum()).unbind())
        n_tok = float(counts[0].sum())
        out["routes"] = [torch.cat([inf[i][3] for inf in infos]) for i in range(len(fracs))]
        out["flips"] = int(sum(inf[i][1] for inf in infos for i in range(len(fracs))))
        out["compared"] = sum(inf[i][2] for inf in infos for i in range(len(fracs)))
    for a in range(0, rows, chunk):
        o, aux, _ = ref.forward(x[a:a + chunk], a, seed, fracs, n_tok, routes=routes)
        part = soft_cross_entropy_sum(o, y[a:a + chunk]) / rows + aux
        part.backward()
        out["loss"] += float(part.detach())
    return out


def follow(model: dict, pipeline: dict, opt: dict, sample_rate: int, params0: dict,
           batches: list, steps_per_epoch: int, n_real: int, n_pad: int,
           prec: str = "f32", rows: int | None = None, routes: list | None = None) -> dict:
    """Run the reference over ``batches``, each (waves (B, T), one-hot
    labels (B, C), ``inputs.Draws``, dropout seed), from ``params0``.
    ``rows`` < B takes the loss over the first ``rows`` rows only (the
    fault of half a batch left out). ``routes``: for each step, the MoE
    blocks' choices of another run to replay (``Reference.forward``); the
    result holds the routes taken and, when replaying, the share of replayed
    choices that differ from the reference's own."""
    p = {n: t.detach().clone().requires_grad_(True) for n, t in params0.items()}
    ref = Reference(model, p, n_pad, prec)
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    b1, b2 = opt["betas"]
    losses, first, taken, flips, compared = [], {}, [], 0, 0
    drops = model.get("dropout", 0.0) > 0
    for t, (wave, onehot, d, seed) in enumerate(batches):
        with torch.no_grad():
            x, y = feats.augment(feats.features(wave, sample_rate, pipeline), onehot, d)
        got = step_grads(ref, x, y, seed if drops else None, rows or x.shape[0],
                         chunk_rows(model, n_real), None if routes is None else routes[t])
        ref.masks.clear()
        losses.append(got["loss"])
        taken.append(got.get("routes"))
        flips += got.get("flips", 0)
        compared += got.get("compared", 0)
        with torch.no_grad():
            g = {n: q.grad for n, q in p.items()}
            norm = torch.sqrt(sum(gg.double().square().sum() for gg in g.values()))
            clip = opt["gradient_clip_val"]
            scale = clip / norm if clip and norm >= clip else 1.0
            lr = lr_at(opt, t, steps_per_epoch)
            for n, q in p.items():
                gg = g[n] * float(scale) + opt["weight_decay"] * q
                if t == 0:
                    first[n] = gg.clone()
                m[n].mul_(b1).add_(gg, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(gg, gg, value=1 - b2)
                c1, c2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
                q.sub_(lr / c1 * m[n] / ((v[n] / c2).sqrt() + opt["eps"]))
                q.grad = None
    change = {n: p[n].detach() - params0[n] for n in p}
    out = {"losses": losses, "grad": unit_norms(first), "change": unit_norms(change)}
    if ref.moe:   # free, it dispatches the top k of its own gates, as a program should
        out["routes"] = taken
        if routes is None:
            out["route_topk_gap"] = 0.0
    if compared:
        out["route_flip_share"] = flips / compared
    return out
