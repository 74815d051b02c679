"""Layers shared by the CNN families (EnvNet-v2, the spectrogram CNN, LEAF).

- ``BatchNorm``: Flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over
  the channel axis 1. In train mode it normalises with the batch's biased
  variance and updates ``running_mean`` / ``running_var`` as 0.9·old +
  0.1·batch with the biased batch variance (``nn.BatchNorm`` would use the
  unbiased one there, B/(B-1) larger over B rows); it reduces in f32 (at
  least) whatever the input's dtype. ``num_batches_tracked`` counts the updates.
  Under data parallelism (``parallel/``) ``group`` is the ranks whose rows
  make up the global batch, and the statistics are the global batch's, as
  GSPMD computes them: SyncBatchNorm's semantics, with autograd-aware sums.
- ``conv`` / ``linear``: a layer applied in the input's dtype, its f32
  weights cast at use (a Flax layer with ``dtype``).
- ``flax_params``: the state_dict keys of a Flax module path, for
  ``models/convert.py``.
- ``CNNBase``: the forward contract of these models, the one the train step
  calls for every family: ``model(x, dropout_seed=None, return_aux=False,
  rows=None)``; with ``return_aux``, (outputs, 0.0, {}) (no MoE aux loss,
  no stats); ``rows`` as ``ASTViT.forward``'s.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
import torch.nn.functional as F
from torch import nn

from dlsc_tpu_torch.ops.dropout_draw import make_draw

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """Flax's BatchNorm (see the module docstring) on (B, C, ...)."""

    def __init__(self, num_features: int, momentum: float = BN_MOMENTUM, eps: float = BN_EPS):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)
        self.flax_momentum = momentum
        self.group: dist.ProcessGroup | None = None   # set by parallel/

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.ndim < 2 or x.shape[1] != self.num_features:
            raise ValueError(f"BatchNorm({self.num_features}) got input {tuple(x.shape)}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))   # f32 at least
        if not self.training:
            y = F.batch_norm(xf, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
            return y.to(x.dtype)
        dims = [0, *range(2, x.ndim)]
        if self.group is not None:
            return self._global_batch(xf, dims).to(x.dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dims, correction=0)
            self._track(mean, var)
        y = F.batch_norm(xf, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y.to(x.dtype)

    @torch.no_grad()
    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.flax_momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)
        self.num_batches_tracked.add_(1)

    def _global_batch(self, xf: torch.Tensor, dims: list[int]) -> torch.Tensor:
        """Train-mode normalisation with the mean and biased variance of the
        global batch: the sums (count, Σx, then Σ(x - mean)²) are reduced
        over ``group`` with autograd, so the gradients are the global
        batch's too once the ranks' gradients are averaged."""
        shape = [1, -1] + [1] * (xf.ndim - 2)
        n = xf.numel() // xf.shape[1]
        s1 = dist_nn.all_reduce(torch.cat([torch.full((1,), float(n), dtype=xf.dtype,
                                                      device=xf.device), xf.sum(dims)]),
                                group=self.group)
        mean = s1[1:] / s1[0]
        d = xf - mean.view(shape)
        var = dist_nn.all_reduce(d.square().sum(dims), group=self.group) / s1[0]
        self._track(mean.detach(), var.detach())
        y = d * torch.rsqrt(var + self.eps).view(shape)
        return y * self.weight.view(shape) + self.bias.view(shape)


def conv(x: torch.Tensor, layer: nn.Conv1d | nn.Conv2d, stride=1, padding=0) -> torch.Tensor:
    """``layer`` on ``x`` in x's dtype."""
    fn = F.conv1d if isinstance(layer, nn.Conv1d) else F.conv2d
    return fn(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype), stride=stride,
              padding=padding)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def normal_(t: torch.Tensor, variance: float, gen: torch.Generator | None) -> None:
    """JAX's ``variance_scaling(..., "normal")``: an untruncated normal."""
    t.normal_(0.0, math.sqrt(variance), generator=gen)


def trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator | None) -> None:
    """A normal of ``std`` truncated to ±2 std (Flax's truncated normal)."""
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator | None) -> None:
    """Flax's default kernel init: truncated normal, variance 1/fan_in."""
    # 0.8796... is the std of a unit normal truncated to [-2, 2]
    trunc_normal_(t, math.sqrt(1.0 / fan_in) / 0.87962566103423978, gen)


def fans(weight: torch.Tensor) -> tuple[int, int]:
    """(fan_in, fan_out) of a torch conv (out, in, *k) or Linear (out, in) weight."""
    receptive = math.prod(weight.shape[2:])
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def flax_params(flax_path: str, torch_path: str, kind: str) -> dict[str, str]:
    """{Flax ``module/leaf``: state_dict key} of one layer: ``kind`` 'conv'
    and 'dense' (kernel, bias), 'bn' (scale, bias, and the batch stats mean,
    var)."""
    leaves = {"conv": (("kernel", "weight"), ("bias", "bias")),
              "dense": (("kernel", "weight"), ("bias", "bias")),
              "bn": (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                     ("var", "running_var"))}[kind]
    return {f"{flax_path}/{a}": f"{torch_path}.{b}" for a, b in leaves}


class CNNBase(nn.Module):
    """Shared forward contract and construction of the CNN families. A
    subclass builds its layers, then calls ``_finish``, and defines
    ``_init(generator)`` (its seeded init), ``logits(x, draw)`` (dropout
    masks keyed by ``draw``, ``ops.dropout_draw.Draw``, none when it is
    None; each dropout layer its own site) and ``flax_names()``."""

    config: dict

    def _finish(self, dtype: torch.dtype, device, generator) -> None:
        self.dtype = dtype
        self._init(generator)
        if device is not None:
            self.to(device)
        self.eval()

    def forward(self, x: torch.Tensor, dropout_seed: int | None = None,
                return_aux: bool = False, rows: tuple[int, int] | None = None):
        """Logits (B, num_classes) f32; with ``return_aux``, (logits, 0.0,
        {}). ``dropout_seed`` seeds this call's dropout masks in train mode
        (drawn from torch's default generator when None); ``rows`` =
        (start, total): x's rows of a global batch, whose masks they are
        (``ops.dropout_draw.Draw``)."""
        draw = None
        if self.training:
            seed = int(torch.randint(2**62, ())) if dropout_seed is None else dropout_seed
            draw = make_draw(seed if torch.is_tensor(seed) else int(seed), rows, x.shape[0])
        out = self.logits(x, draw)
        return (out, 0.0, {}) if return_aux else out


def as_dtype(dtype: torch.dtype | str) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")

