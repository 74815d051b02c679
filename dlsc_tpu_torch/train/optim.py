"""Optimizer and learning-rate schedule factories.

Counterpart of ``dlsc_tpu/train/optim.py``, which lowers torch-style specs to
optax; here they lower to ``torch.optim`` itself:

- ``adam``: ``torch.optim.Adam``, whose weight decay is L2 added to the
  gradient ahead of the moments (optax ``add_decayed_weights`` before
  ``scale_by_adam``);
- ``adamw``: ``torch.optim.AdamW``, decoupled decay;
- ``sgd``: ``torch.optim.SGD`` (L2, then heavy-ball momentum, no dampening:
  optax ``trace``).

Schedules step per *epoch*, like torch schedulers: ``lr_schedule`` maps a
step count to the LR of its epoch. The caller sets every param group's LR
from the count *before* ``optimizer.step()`` increments it, so step 0 runs
at lr(0), as optax's ``scale_by_schedule`` does. ``clip_by_global_norm_``
is optax's clip (scale by max_norm / norm only when norm >= max_norm), not
``torch.nn.utils.clip_grad_norm_`` (which divides by norm + 1e-6); it runs
first, ahead of the L2 term. ``TrainState.apply_gradients`` does the three
in that order. ``swa_lr_wrap`` bakes SWA's annealing phase into the
schedule, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    name: str
    lr: float
    weight_decay: float = 0.0
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    momentum: float = 0.0


@dataclasses.dataclass(frozen=True)
class SchedulerSpec:
    name: str
    T_max: int = 100
    eta_min: float = 0.0
    step_size: int = 30
    gamma: float = 0.1


def adam(lr: float = 1e-3, weight_decay: float = 0.0, betas=(0.9, 0.999),
         eps: float = 1e-8, **_) -> OptimizerSpec:
    return OptimizerSpec("adam", float(lr), float(weight_decay), tuple(betas), float(eps))


def adamw(lr: float = 1e-3, weight_decay: float = 1e-2, betas=(0.9, 0.999),
          eps: float = 1e-8, **_) -> OptimizerSpec:
    return OptimizerSpec("adamw", float(lr), float(weight_decay), tuple(betas), float(eps))


def sgd(lr: float = 1e-2, momentum: float = 0.0, weight_decay: float = 0.0, **_) -> OptimizerSpec:
    return OptimizerSpec("sgd", float(lr), float(weight_decay), momentum=float(momentum))


def cosine_annealing(T_max: int, eta_min: float = 0.0, **_) -> SchedulerSpec:
    return SchedulerSpec("cosine", T_max=int(T_max), eta_min=float(eta_min))


def step_lr(step_size: int = 30, gamma: float = 0.1, **_) -> SchedulerSpec:
    return SchedulerSpec("step", step_size=int(step_size), gamma=float(gamma))


def lr_schedule(optim: OptimizerSpec, sched: SchedulerSpec | None,
                steps_per_epoch: int) -> Callable[[int], float]:
    """Per-step LR function, constant within an epoch."""
    base = optim.lr
    if sched is not None and sched.name not in ("cosine", "step"):
        raise ValueError(f"Unknown scheduler {sched.name}")

    def fn(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        if sched is None:
            return base
        if sched.name == "cosine":  # torch CosineAnnealingLR closed form
            return sched.eta_min + (base - sched.eta_min) * 0.5 * (
                1.0 + math.cos(math.pi * epoch / sched.T_max))
        return base * sched.gamma ** (epoch // sched.step_size)

    return fn


def swa_lr_wrap(base: Callable[[int], float], *, swa_lr: float, start_epoch: int,
                annealing_epochs: int, steps_per_epoch: int) -> Callable[[int], float]:
    """SWA's learning rate (torch ``SWALR``, as Lightning's SWA callback
    runs it): from ``start_epoch`` the LR cosine-anneals from the scheduled
    value at SWA's start down to ``swa_lr`` over ``annealing_epochs``
    epochs, then holds ``swa_lr``; before it, ``base``."""
    spe = max(steps_per_epoch, 1)
    lr0 = float(base(start_epoch * spe))
    ann = max(int(annealing_epochs), 1)

    def fn(step: int) -> float:
        epoch = step // spe
        if epoch < start_epoch:
            return base(step)
        t = min(1.0, (epoch - start_epoch + 1) / ann)
        return swa_lr + (lr0 - swa_lr) * 0.5 * (1.0 + math.cos(math.pi * t))

    return fn


def build_optimizer(params: Iterable[torch.nn.Parameter], optim: OptimizerSpec,
                    sched: SchedulerSpec | None, steps_per_epoch: int,
                    swa: dict | None = None
                    ) -> tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """(the ``torch.optim`` optimizer over ``params``, the per-step LR).
    ``swa``: optional {"swa_lr", "start_epoch", "annealing_epochs"}, SWA's
    phase of the schedule (``swa_lr_wrap``)."""
    params = list(params)
    if optim.name == "adam":
        opt = torch.optim.Adam(params, lr=optim.lr, betas=optim.betas, eps=optim.eps,
                               weight_decay=optim.weight_decay)
    elif optim.name == "adamw":
        opt = torch.optim.AdamW(params, lr=optim.lr, betas=optim.betas, eps=optim.eps,
                                weight_decay=optim.weight_decay)
    elif optim.name == "sgd":
        opt = torch.optim.SGD(params, lr=optim.lr, momentum=optim.momentum,
                              weight_decay=optim.weight_decay)
    else:
        raise ValueError(f"Unknown optimizer {optim.name}")
    lr_fn = lr_schedule(optim, sched, steps_per_epoch)
    if swa and swa.get("swa_lr") is not None:
        lr_fn = swa_lr_wrap(lr_fn, swa_lr=float(swa["swa_lr"]),
                            start_epoch=int(swa["start_epoch"]),
                            annealing_epochs=int(swa.get("annealing_epochs", 10)),
                            steps_per_epoch=steps_per_epoch)
    return opt, lr_fn


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: when the global L2 norm is
    >= ``max_norm``, scale every gradient by max_norm / norm. Returns the
    norm (a 0-d tensor, no host sync)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm
