"""Train augmentations and crops: one-hot labels, SpecAugment and Mixup
(AST), waveform crops, time stretch, gain shift and Between-Class mixing
(EnvNet-v2, LEAF), flips and translation (the spectrogram-image CNN).

Counterpart of ``dlsc_tpu/ops/augment.py``: ``one_hot`` :37,
``pad_or_trim`` :41, ``random_crop``, ``center_crop`` and ``multi_crop``
:58-96, ``time_stretch`` :102, ``gain_shift`` :128, ``spec_augment`` :143,
``image_flip_translate`` :183, ``_random_partners`` :208, ``mixup`` :222 and
``bc_mix`` with ``_rms_spl_db`` and ``_perceptual_coefficient`` :258-306.
Each random augmentation is split in two:

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
  spectrogram and the soft labels;
- time stretch evaluates the linearly interpolated stretched signal on the
  original grid (``align_corners=False``), zero past its end, so the length
  stays fixed; stretch and gain each fire per sample with probability 0.5;
- BC mixing mixes every sample with a partner drawn as Mixup's, at a
  loudness-adjusted ratio p, as (p·x1 + (1-p)·x2)/sqrt(p² + (1-p)²), and its
  labels with the raw r; a partner of the same class leaves the sample
  unmixed;
- test-time crops start at ``floor(linspace(0, T - window, n))``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

MIXUP_PROB = 0.25   # the reference's double gate, 0.5 x 0.5


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(labels.long(), num_classes).float()


def _on(device: torch.device, draws):
    """``draws`` (a dataclass of tensors) with every tensor on ``device``."""
    return type(draws)(*(t.to(device, non_blocking=True) for t in dataclasses.astuple(draws)))


@dataclasses.dataclass(frozen=True)
class SpecAugmentDraws:
    """Per-sample mask starts and lengths, (B,) int64; length 0 = no mask."""

    t_start: torch.Tensor
    t_len: torch.Tensor
    f_start: torch.Tensor
    f_len: torch.Tensor

    def to(self, device: torch.device) -> "SpecAugmentDraws":
        return _on(device, self)


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
        return _on(device, self)


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


# --------------------------------------------------------------------------- #
# Waveform crops
# --------------------------------------------------------------------------- #
def pad_or_trim(wave: torch.Tensor, target_len: int) -> torch.Tensor:
    """Wrap-pad a short clip, centre-trim a long one, to ``target_len``
    samples on the last axis."""
    n = wave.shape[-1]
    if n == target_len:
        return wave
    if n < target_len:
        return torch.cat([wave] * -(-target_len // n), dim=-1)[..., :target_len]
    start = (n - target_len) // 2
    return wave[..., start:start + target_len]


def crop_draws(batch: int, num_samples: int, window: int,
               rng: np.random.Generator) -> torch.Tensor:
    """Per-sample crop starts, (B,) int64, uniform over [0, T - window]
    (zeros when the clip is no longer than the window)."""
    if num_samples <= window:
        return torch.zeros(batch, dtype=torch.int64)
    return torch.from_numpy(rng.integers(0, num_samples - window + 1, batch).astype(np.int64))


def _windows(wave: torch.Tensor, starts: torch.Tensor, window: int) -> torch.Tensor:
    """wave[b, starts[b] + j] for j < window, per row: (B, T) → (B, window)."""
    idx = starts.to(wave.device)[:, None] + torch.arange(window, device=wave.device)
    return wave.gather(1, idx)


def random_crop(wave: torch.Tensor, starts: torch.Tensor, window: int) -> torch.Tensor:
    """The window of each row at its drawn start; a clip no longer than the
    window is zero-padded at its end. (B, T) → (B, window)."""
    if wave.shape[-1] <= window:
        return F.pad(wave, (0, window - wave.shape[-1]))
    return _windows(wave, starts, window)


def center_crop(wave: torch.Tensor, window: int) -> torch.Tensor:
    n = wave.shape[-1]
    if n <= window:
        return F.pad(wave, (0, window - n))
    start = (n - window) // 2
    return wave[..., start:start + window]


def multi_crop(wave: torch.Tensor, window: int, n_crops: int = 10) -> torch.Tensor:
    """Evenly spaced test-time crops, (B, T) → (B, n_crops, window)."""
    B, n = wave.shape
    if n <= window:
        return F.pad(wave, (0, window - n))[:, None].expand(B, n_crops, window)
    starts = np.floor(np.linspace(0.0, float(n - window), n_crops, dtype=np.float32))
    idx = torch.from_numpy(starts.astype(np.int64)).to(wave.device)[:, None] \
        + torch.arange(window, device=wave.device)
    return wave[:, idx]


# --------------------------------------------------------------------------- #
# Waveform augmentation
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class GatedDraws:
    """Per-sample gate (bool) and factor (f32): a time-stretch factor or a
    gain in dB."""

    gate: torch.Tensor
    value: torch.Tensor

    def to(self, device: torch.device) -> "GatedDraws":
        return _on(device, self)


def gated_draws(batch: int, low: float, high: float, rng: np.random.Generator,
                prob: float = 0.5) -> GatedDraws:
    """A gate with probability ``prob`` and a value ~ U(low, high), per sample."""
    gate = rng.random(batch) < prob
    value = rng.uniform(low, high, batch).astype(np.float32)
    return GatedDraws(torch.from_numpy(gate), torch.from_numpy(value))


def time_stretch(wave: torch.Tensor, draws: GatedDraws) -> torch.Tensor:
    """Stretch each gated row by its factor f: output sample i reads the
    input at (i + 0.5)·f - 0.5, linearly interpolated, and is zero past the
    input's last sample. (B, T) → (B, T)."""
    n = wave.shape[-1]
    f = draws.value.to(wave.device, torch.float32)[:, None]
    pos = (torch.arange(n, device=wave.device, dtype=torch.float32) + 0.5) * f - 0.5
    lo = pos.floor().to(torch.int64).clamp(0, n - 1)
    hi = (lo + 1).clamp(0, n - 1)
    frac = (pos - lo).clamp(0.0, 1.0)
    vals = wave.gather(1, lo) * (1 - frac) + wave.gather(1, hi) * frac
    stretched = torch.where(pos <= n - 1, vals, torch.zeros((), device=wave.device))
    return torch.where(draws.gate.to(wave.device)[:, None], stretched, wave)


def gain_shift(wave: torch.Tensor, draws: GatedDraws) -> torch.Tensor:
    """Scale each gated row by 10^(dB / 20)."""
    gain = torch.pow(10.0, draws.value.to(wave.device, torch.float32) / 20.0)
    return torch.where(draws.gate.to(wave.device)[:, None], wave * gain[:, None], wave)


# --------------------------------------------------------------------------- #
# Image augmentation for the spectrogram-image CNN
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class FlipDraws:
    """Per-sample horizontal and vertical flips (bool) and integer shifts
    along the width (dx) and the height (dy), int64."""

    hflip: torch.Tensor
    vflip: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor

    def to(self, device: torch.device) -> "FlipDraws":
        return _on(device, self)


def flip_draws(batch: int, height: int, width: int, rng: np.random.Generator,
               translate: float = 0.1) -> FlipDraws:
    """Flips with probability 0.5 each, shifts uniform over
    [-translate·dim, translate·dim] (truncated to integers)."""
    max_dx, max_dy = int(translate * width), int(translate * height)
    hflip = rng.random(batch) < 0.5
    vflip = rng.random(batch) < 0.5
    dx = rng.integers(-max_dx, max_dx + 1, batch)
    dy = rng.integers(-max_dy, max_dy + 1, batch)
    return FlipDraws(torch.from_numpy(hflip), torch.from_numpy(vflip),
                     *(torch.from_numpy(a.astype(np.int64)) for a in (dx, dy)))


def image_flip_translate(img: torch.Tensor, draws: FlipDraws) -> torch.Tensor:
    """Flip each image as drawn, then shift it by (dy, dx) with zero fill.
    img: (B, H, W)."""
    B, H, W = img.shape
    d = draws.to(img.device)
    img = torch.where(d.hflip[:, None, None], img.flip(-1), img)
    img = torch.where(d.vflip[:, None, None], img.flip(-2), img)
    rows = torch.arange(H, device=img.device)[None, :] - d.dy[:, None]      # (B, H)
    cols = torch.arange(W, device=img.device)[None, :] - d.dx[:, None]      # (B, W)
    out = img.gather(1, rows.clamp(0, H - 1)[:, :, None].expand(B, H, W))
    out = out.gather(2, cols.clamp(0, W - 1)[:, None, :].expand(B, H, W))
    valid = (((rows >= 0) & (rows < H))[:, :, None]) & (((cols >= 0) & (cols < W))[:, None, :])
    return torch.where(valid, out, torch.zeros((), dtype=img.dtype, device=img.device))


# --------------------------------------------------------------------------- #
# Between-Class mixing
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class BCDraws:
    """Per-sample mixing ratio r ~ U(0, 1) (f32) and partner index."""

    r: torch.Tensor
    partner: torch.Tensor

    def to(self, device: torch.device) -> "BCDraws":
        return _on(device, self)


def bc_draws(batch: int, rng: np.random.Generator) -> BCDraws:
    return BCDraws(torch.from_numpy(rng.random(batch).astype(np.float32)),
                   torch.from_numpy(random_partners(batch, rng).astype(np.int64)))


def _rms_spl_db(wave: torch.Tensor) -> torch.Tensor:
    """The reference's RMS proxy of the A-weighted SPL: 20·log10(rms) + 94,
    -80 for silence. (B, T) → (B,)."""
    rms = torch.sqrt(torch.mean(wave ** 2, dim=-1))
    return torch.where(rms > 0, 20.0 * torch.log10(rms.clamp_min(1e-20)) + 94.0,
                       torch.full_like(rms, -80.0))


def _perceptual_coefficient(r: torch.Tensor, spl1: torch.Tensor,
                            spl2: torch.Tensor) -> torch.Tensor:
    """r scaled by (1 ∓ min(|Δspl| / 40, 0.3)) where |Δspl| > 10 dB, in [0, 1]."""
    diff = spl1 - spl2
    adj = torch.clamp(diff.abs() / 40.0, max=0.3)
    scaled = torch.where(diff > 0, r * (1 - adj), r * (1 + adj))
    return torch.where(diff.abs() > 10.0, scaled, r).clamp(0.0, 1.0)


def bc_mix(wave: torch.Tensor, labels: torch.Tensor,
           draws: BCDraws) -> tuple[torch.Tensor, torch.Tensor]:
    """Between-Class mix of each sample with its partner (see the module
    docstring). wave: (B, T); labels: (B, C) one-hot."""
    d = draws.to(wave.device)
    partner = d.partner
    same = labels.argmax(-1) == labels[partner].argmax(-1)
    one = torch.ones_like(d.r)
    r = torch.where(same, one, d.r)
    spl1 = _rms_spl_db(wave)
    p = torch.where(same, one, _perceptual_coefficient(r, spl1, spl1[partner]))
    norm = torch.sqrt(p ** 2 + (1 - p) ** 2)
    mixed = (p[:, None] * wave + (1 - p)[:, None] * wave[partner]) / norm[:, None]
    soft = r[:, None] * labels + (1 - r)[:, None] * labels[partner]
    return mixed, soft
