"""Everything a run feeds the system, made from ``--seed``: weights, clips,
labels, the order of the pool, the augmentations' draws, the dropout seeds
and the serving schedule. The program and the reference are handed the same.

Weights and clips are made on the device with a ``torch.Generator`` there,
in a few large calls; the small per-step vectors on the host with numpy.
Each purpose draws from its own stream, ``stream(seed, purpose)``, so the
same seed gives the same inputs whatever else a run makes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

MIXUP_PROB = 0.25   # the AST recipe's double gate, 0.5 x 0.5
STREAMS = {"weights": 1, "clips": 2, "labels": 3, "order": 4, "draws": 5, "dropout": 6,
           "arrivals": 7, "requests": 8}


def stream(seed: int, purpose: str, *more: int) -> int:
    """A 63-bit seed for ``purpose`` (and ``more``) under the run's ``seed``."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), STREAMS[purpose], *more])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def _gen(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, purpose))


def param_shapes(model: dict) -> dict[str, tuple[tuple[int, ...], str, int]]:
    """name -> (shape, init, fan_in) of every parameter of an AST config's
    ``model``, named as the port's ``ASTViT`` state dict names them. init:
    'normal' (std 1/sqrt(fan_in)), 'pos' (std 0.02), 'zero', 'one'."""
    D, C = model["emb_dim"], model["num_classes"]
    F_ = int(model.get("mlp_ratio", 4.0) * D)
    p = model["patch_size"]
    t10 = int(model["sample_rate"] * 10 / 160) + 1   # the 10-s positional table
    step = model["patch_stride"]
    n10 = ((model["f_dim"] - p) // step + 1) * ((t10 - p) // step + 1)
    out = {"cls_token": ((1, 1, D), "zero", 0), "pos_embed": ((1, 1 + n10, D), "pos", 0),
           "patch_embed.weight": ((D, 1, p, p), "normal", p * p),
           "patch_embed.bias": ((D,), "zero", 0)}
    moe = model.get("moe")
    for i in range(model["depth"]):
        b = f"blocks.{i}."
        out.update({b + "norm1.weight": ((D,), "one", 0), b + "norm1.bias": ((D,), "zero", 0),
                    b + "attn.qkv.weight": ((3 * D, D), "normal", D),
                    b + "attn.qkv.bias": ((3 * D,), "zero", 0),
                    b + "attn.proj.weight": ((D, D), "normal", D),
                    b + "attn.proj.bias": ((D,), "zero", 0),
                    b + "norm2.weight": ((D,), "one", 0), b + "norm2.bias": ((D,), "zero", 0)})
        if moe:
            E = moe["n_experts"]
            out.update({b + "moe.wi": ((E, D, F_), "normal", D),
                        b + "moe.bi": ((E, F_), "zero", 0),
                        b + "moe.wo": ((E, F_, D), "normal", F_),
                        b + "moe.bo": ((E, D), "zero", 0),
                        b + "moe.router.weight": ((E, D), "normal", D)})
        else:
            out.update({b + "mlp.fc1.weight": ((F_, D), "normal", D),
                        b + "mlp.fc1.bias": ((F_,), "zero", 0),
                        b + "mlp.fc2.weight": ((D, F_), "normal", F_),
                        b + "mlp.fc2.bias": ((D,), "zero", 0)})
    out.update({"norm.weight": ((D,), "one", 0), "norm.bias": ((D,), "zero", 0),
                "head.weight": ((C, D), "normal", D), "head.bias": ((C,), "zero", 0)})
    return out


@torch.no_grad()
def weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """f32 weights of an AST config on ``device``: one normal draw for all
    drawn parameters, cut and scaled."""
    shapes = param_shapes(model)
    drawn = [(n, s, init, fan) for n, (s, init, fan) in shapes.items()
             if init in ("normal", "pos")]
    total = sum(math.prod(s) for _, s, _, _ in drawn)
    flat = torch.randn(total, generator=_gen(seed, "weights", device), device=device)
    out, at = {}, 0
    for n, s, init, fan in drawn:
        k = math.prod(s)
        out[n] = flat[at:at + k].view(s).mul_(0.02 if init == "pos" else fan ** -0.5)
        at += k
    for n, (s, init, _) in shapes.items():
        if init in ("zero", "one"):
            out[n] = torch.full(s, 1.0 if init == "one" else 0.0, device=device)
    return {n: out[n] for n in shapes}


@torch.no_grad()
def clips(n: int, samples: int, sample_rate: int, seed: int, device,
          chunk: int = 256) -> torch.Tensor:
    """(n, samples) f32 synthetic clips on ``device``: per clip a tone at a
    drawn pitch and level, white noise at a drawn level, under a drawn
    attack-decay envelope, peak-normalised as the data prep does."""
    g = _gen(seed, "clips", device)
    par = torch.rand(n, 5, generator=g, device=device)
    out = torch.empty(n, samples, device=device)
    t = torch.arange(samples, device=device, dtype=torch.float32) / sample_rate
    for a in range(0, n, chunk):
        p = par[a:a + chunk]
        freq = 80.0 * torch.exp(p[:, :1] * math.log(100.0))          # 80 Hz .. 8 kHz
        tone = (0.2 + p[:, 1:2]) * torch.sin(2 * math.pi * freq * t)
        noise = (0.05 + 0.6 * p[:, 2:3]) * torch.randn(len(p), samples, generator=g,
                                                      device=device)
        onset = p[:, 3:4] * (samples / sample_rate) * 0.5
        env = torch.exp(-(t - onset).clamp_min(0) * (0.5 + 4.0 * p[:, 4:5])) * (t >= onset)
        x = (tone + noise) * (0.1 + env)
        out[a:a + chunk] = x / x.abs().amax(1, keepdim=True).clamp_min(1e-6)
    return out


def labels(n: int, classes: int, seed: int) -> np.ndarray:
    return np.random.default_rng(stream(seed, "labels")).integers(0, classes, n)


def order(step: int, pool: int, batch: int, seed: int) -> np.ndarray:
    """The pool rows of train step ``step``: epochs are seeded permutations
    of the pool, cut into ``pool // batch`` batches, so the rows of the
    steps of one epoch all differ."""
    per = pool // batch
    perm = np.random.default_rng(stream(seed, "order", step // per)).permutation(pool)
    i = step % per
    return perm[i * batch:(i + 1) * batch]


@dataclasses.dataclass(frozen=True)
class Draws:
    """One AST train batch's random vectors, (B,) each: SpecAugment's mask
    starts and lengths (length 0: no mask), Mixup's gate, weight and
    partner (another row, never itself)."""

    t_start: np.ndarray
    t_len: np.ndarray
    f_start: np.ndarray
    f_len: np.ndarray
    gate: np.ndarray
    lam: np.ndarray
    partner: np.ndarray


def _mask(rng: np.random.Generator, batch: int, dim: int, param: int):
    if param <= 0 or dim <= param:
        return np.zeros(batch, np.int64), np.zeros(batch, np.int64)
    length = rng.integers(1, min(param, dim // 4) + 1, batch)
    return rng.integers(0, dim - length + 1).astype(np.int64), length.astype(np.int64)


def draws(step: int, batch: int, frames: int, pipeline: dict, seed: int) -> Draws:
    """The draws of train step ``step`` (the AST recipe: one time and one
    mel mask a clip, Mixup gated per clip at ``MIXUP_PROB`` with a
    Beta(alpha, alpha) weight)."""
    rng = np.random.default_rng(stream(seed, "draws", step))
    t0, tl = _mask(rng, batch, frames, pipeline["time_mask"])
    f0, fl = _mask(rng, batch, pipeline["n_mels"], pipeline["freq_mask"])
    a = pipeline["mixup_alpha"] if pipeline["enable_mixup"] else 0.0
    gate = rng.random(batch) < (MIXUP_PROB if a > 0 else 0.0)
    lam = (rng.beta(a, a, batch) if a > 0 else np.ones(batch)).astype(np.float32)
    partner = (np.arange(batch) + rng.integers(1, max(batch, 2), batch)) % batch
    return Draws(t0, tl, f0, fl, gate, lam, partner.astype(np.int64))


def dropout_seed(step: int, seed: int) -> int:
    return stream(seed, "dropout", step)


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Sorted send times in [0, seconds) of round(rate · seconds) requests:
    a Poisson process given its count, so every seed sends as many."""
    n = int(round(rate * seconds))
    return np.sort(np.random.default_rng(stream(seed, "arrivals")).uniform(0.0, seconds, n))


def request_clips(n: int, pool: int, seed: int) -> np.ndarray:
    """The pool clip of each of ``n`` requests."""
    return np.random.default_rng(stream(seed, "requests")).integers(0, pool, n)
