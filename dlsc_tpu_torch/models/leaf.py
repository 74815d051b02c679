"""LEAF: a learnable Gabor front end, PCEN and a 1-D CNN.

Counterpart of ``dlsc_tpu/models/leaf.py`` (:37-177):

- ``GaborConv1d``: complex Gabor filters rebuilt every forward from the
  learnable ``center_freqs`` (initialised to ``linspace(min_freq,
  max_freq, F)`` / Nyquist) and ``bandwidths`` (ones), each a cosine and a
  sine at 2π·center·t under exp(-(t·bw·sr)²/2) and a periodic Hann window,
  with t in *seconds* (the reference's quirk: the phase stays near 0 across
  the kernel). The two filter sets are one ``conv1d`` with 2F output
  channels (real, then imaginary), SAME padding; the energy is real² +
  imag²; then AvgPool(160). The JAX package streams this in time chunks
  under ``lax.map`` to fit a TPU's memory; here it is one convolution.
- ``PCEN``: log(x / (eps + M)^r + δ) with M the 5-tap moving average that
  counts the zero padding; α is a parameter that the forward does not use
  (kept, as the reference keeps it, so checkpoints carry the same state).
- three Conv1d(SAME)-BN-ReLU-maxpool blocks (256/5/4, 384/3/4, 512/3/2), the
  mean over time, and an MLP 256 → 512 → 256 of Dense-BN-ReLU-dropout(0.3),
  then Dense num_classes.

Weights: Flax's default init (truncated LeCun normal, zero biases).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dlsc_tpu_torch.models.layers import (BatchNorm, CNNBase, as_dtype, conv, dtype_name,
                                          fans, flax_params, lecun_normal_, linear)
from dlsc_tpu_torch.ops.dropout_draw import Draw, dropout
from dlsc_tpu_torch.ops.mel import hann_window_np

POOL = 160                 # the energy's downsampling before PCEN
PCEN_EPS = 1e-6
BLOCKS = ((256, 5, 4), (384, 3, 4), (512, 3, 2))   # (channels, kernel, max pool)
MLP = (256, 512, 256)
DROPOUT = 0.3


class GaborConv1d(nn.Module):
    """(B, T) → the Gabor energy pooled by ``pool``: (B, F, T // pool)."""

    def __init__(self, n_filters: int = 186, kernel_size: int = 401,
                 sample_rate: int = 44_100, min_freq: float = 60.0, max_freq: float = 7800.0):
        super().__init__()
        self.kernel_size, self.sample_rate = kernel_size, sample_rate
        nyquist = sample_rate / 2
        self.center_freqs = nn.Parameter(
            torch.linspace(min_freq, max_freq, n_filters, dtype=torch.float32) / nyquist)
        self.bandwidths = nn.Parameter(torch.ones(n_filters))
        half = kernel_size // 2
        self.register_buffer("t", torch.arange(-half, half + 1, dtype=torch.float32)
                             / sample_rate, persistent=False)
        self.register_buffer("window", torch.from_numpy(
            hann_window_np(kernel_size).astype(np.float32)), persistent=False)

    def filters(self) -> torch.Tensor:
        """(2F, 1, K): the real filters, then the imaginary ones."""
        t = self.t[None, :]
        env = torch.exp(-0.5 * (t * self.bandwidths[:, None] * self.sample_rate) ** 2)
        phase = 2.0 * math.pi * self.center_freqs[:, None] * t
        w = env * self.window
        return torch.cat([torch.cos(phase) * w, torch.sin(phase) * w])[:, None, :]

    def forward(self, x: torch.Tensor, pool: int = POOL) -> torch.Tensor:
        n = self.center_freqs.shape[0]
        out = F.conv1d(x[:, None], self.filters().to(x.dtype), padding=self.kernel_size // 2)
        energy = out[:, :n] ** 2 + out[:, n:] ** 2                 # (B, F, T)
        return F.avg_pool1d(energy, pool)


class PCEN(nn.Module):
    def __init__(self, num_channels: int, alpha: float = 0.98, delta: float = 2.0,
                 r: float = 0.5):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((num_channels,), alpha))   # unused, as there
        self.delta = nn.Parameter(torch.full((num_channels,), delta))
        self.r = nn.Parameter(torch.full((num_channels,), r))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, C, T)
        m = F.avg_pool1d(x, 5, stride=1, padding=2, count_include_pad=True)
        r, delta = self.r[None, :, None].to(x.dtype), self.delta[None, :, None].to(x.dtype)
        return torch.log(x / (PCEN_EPS + m) ** r + delta)


class LeafModel(CNNBase):
    """LEAF on (B, T) or (B, 1, T) waveforms; ``forward`` as
    ``layers.CNNBase``. ``unreached_parameters``: the parameters that the
    loss does not reach (PCEN's α), which data parallelism must expect to
    get no gradient."""

    unreached_parameters = ("pcen.alpha",)

    def __init__(self, n_filters: int = 186, kernel_size: int = 401,
                 sample_rate: int = 44_100, num_classes: int = 50,
                 dtype: torch.dtype | str = torch.float32,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dtype = as_dtype(dtype)
        self.config = dict(n_filters=n_filters, kernel_size=kernel_size,
                           sample_rate=sample_rate, num_classes=num_classes,
                           dtype=dtype_name(dtype))
        self.gabor = GaborConv1d(n_filters, kernel_size, sample_rate)
        self.pcen = PCEN(n_filters)
        cin, convs, bns = n_filters, [], []
        for cout, k, _ in BLOCKS:
            convs.append(nn.Conv1d(cin, cout, k))
            bns.append(BatchNorm(cout))
            cin = cout
        self.convs, self.conv_bns = nn.ModuleList(convs), nn.ModuleList(bns)
        widths = (cin, *MLP)
        self.mlp = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.mlp_bns = nn.ModuleList(BatchNorm(w) for w in MLP)
        self.head = nn.Linear(MLP[-1], num_classes)
        self._finish(dtype, device, generator)

    @torch.no_grad()
    def _init(self, gen: torch.Generator | None) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.Linear)):
                lecun_normal_(m.weight, fans(m.weight)[0], gen)
                m.bias.zero_()

    def flax_names(self) -> dict[str, str]:
        names = {"GaborConv1d_0/center_freqs": "gabor.center_freqs",
                 "GaborConv1d_0/bandwidths": "gabor.bandwidths",
                 **{f"PCEN_0/{p}": f"pcen.{p}" for p in ("alpha", "delta", "r")}}
        for i in range(len(BLOCKS)):
            names.update(flax_params(f"Conv_{i}", f"convs.{i}", "conv"))
            names.update(flax_params(f"BatchNorm_{i}", f"conv_bns.{i}", "bn"))
        for i in range(len(MLP)):
            names.update(flax_params(f"Dense_{i}", f"mlp.{i}", "dense"))
            names.update(flax_params(f"BatchNorm_{len(BLOCKS) + i}", f"mlp_bns.{i}", "bn"))
        names.update(flax_params(f"Dense_{len(MLP)}", "head", "dense"))
        return names

    def logits(self, x: torch.Tensor, draw: Draw | None) -> torch.Tensor:
        if x.ndim == 3:
            x = x[:, 0]
        x = self.pcen(self.gabor(x.to(self.dtype)))                  # (B, F, T // 160)
        for (_, k, pool), cv, bn in zip(BLOCKS, self.convs, self.conv_bns):
            x = F.max_pool1d(F.relu(bn(conv(x, cv, padding=(k - 1) // 2))), pool)
        x = x.mean(dim=-1)                                           # (B, 512)
        for site, (layer, bn) in enumerate(zip(self.mlp, self.mlp_bns)):
            x = dropout(F.relu(bn(linear(x, layer))), DROPOUT, draw, site)
        return F.linear(x.float(), self.head.weight.float(), self.head.bias.float())
