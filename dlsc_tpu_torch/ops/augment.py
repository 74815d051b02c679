"""AST train augmentations: one-hot labels, SpecAugment and Mixup.

Counterpart of ``dlsc_tpu/ops/augment.py`` (``one_hot`` :37,
``spec_augment`` :143, ``_random_partners`` :208, ``mixup`` :222). Each
augmentation is split in two:

- a ``*_draws`` function that draws the B-sized random vectors on the host
  from an explicit ``numpy.random.Generator``;
- a function that applies given draws to a batch on its device.

Tests hand both packages the same draws (``jax.random`` and numpy streams
never match). The reference's quirks are kept:

- one time mask and one frequency mask per sample, zero fill; a mask's
  length is in [1, min(param, dim // 4)] and it applies only when
  ``dim > param``;
- Mixup fires per sample with probability 0.25, the partner is another
  sample of the batch (never itself), and the mix is convex on both the
  spectrogram and the soft labels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

MIXUP_PROB = 0.25   # the reference's double gate, 0.5 x 0.5


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(labels.long(), num_classes).float()


@dataclasses.dataclass(frozen=True)
class SpecAugmentDraws:
    """Per-sample mask starts and lengths, (B,) int64; length 0 = no mask."""

    t_start: torch.Tensor
    t_len: torch.Tensor
    f_start: torch.Tensor
    f_len: torch.Tensor

    def to(self, device: torch.device) -> "SpecAugmentDraws":
        return SpecAugmentDraws(*(t.to(device, non_blocking=True)
                                  for t in dataclasses.astuple(self)))


def _mask_draws(batch: int, dim: int, param: int,
                rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    if param <= 0 or dim <= param:
        return np.zeros(batch, np.int64), np.zeros(batch, np.int64)
    cap = min(param, dim // 4)
    length = rng.integers(1, cap + 1, batch)
    start = rng.integers(0, dim - length + 1)
    return start, length


def spec_augment_draws(batch: int, n_mels: int, n_frames: int, time_mask: int,
                       freq_mask: int, rng: np.random.Generator) -> SpecAugmentDraws:
    t_start, t_len = _mask_draws(batch, n_frames, time_mask, rng)
    f_start, f_len = _mask_draws(batch, n_mels, freq_mask, rng)
    return SpecAugmentDraws(*(torch.from_numpy(np.asarray(a, np.int64))
                              for a in (t_start, t_len, f_start, f_len)))


def _span(start: torch.Tensor, length: torch.Tensor, dim: int) -> torch.Tensor:
    idx = torch.arange(dim, device=start.device)
    return (idx >= start[:, None]) & (idx < (start + length)[:, None])


def spec_augment(spec: torch.Tensor, draws: SpecAugmentDraws) -> torch.Tensor:
    """Zero one time span and one mel span per sample. spec: (B, n_mels, T)."""
    _, n_mels, n_frames = spec.shape
    tmask = _span(draws.t_start, draws.t_len, n_frames)   # (B, T)
    fmask = _span(draws.f_start, draws.f_len, n_mels)     # (B, n_mels)
    return spec.masked_fill(tmask[:, None, :] | fmask[:, :, None], 0.0)


@dataclasses.dataclass(frozen=True)
class MixupDraws:
    """Per-sample gate (bool), mixing weight lam (f32) and partner index."""

    gate: torch.Tensor
    lam: torch.Tensor
    partner: torch.Tensor

    def to(self, device: torch.device) -> "MixupDraws":
        return MixupDraws(*(t.to(device, non_blocking=True)
                            for t in dataclasses.astuple(self)))


def random_partners(batch: int, rng: np.random.Generator) -> np.ndarray:
    """partner[i] = (i + offset_i) mod B with offset_i ~ U{1..B-1}: uniform
    over the other samples, never i itself."""
    if batch <= 1:
        return np.zeros(batch, np.int64)
    return (np.arange(batch) + rng.integers(1, batch, batch)) % batch


def mixup_draws(batch: int, alpha: float, rng: np.random.Generator) -> MixupDraws:
    gate = rng.random(batch) < MIXUP_PROB
    lam = np.ones(batch) if alpha <= 0 else rng.beta(alpha, alpha, batch)
    return MixupDraws(torch.from_numpy(gate),
                      torch.from_numpy(lam.astype(np.float32)),
                      torch.from_numpy(random_partners(batch, rng).astype(np.int64)))


def mixup(spec: torch.Tensor, labels: torch.Tensor,
          draws: MixupDraws) -> tuple[torch.Tensor, torch.Tensor]:
    """Convex mix of each gated sample with its partner, spectrogram and
    soft labels (B, C) alike."""
    lam = torch.where(draws.gate, draws.lam, torch.ones_like(draws.lam))
    ls = lam.reshape((-1,) + (1,) * (spec.ndim - 1))
    mixed = ls * spec + (1 - ls) * spec[draws.partner]
    soft = lam[:, None] * labels + (1 - lam[:, None]) * labels[draws.partner]
    return mixed, soft
