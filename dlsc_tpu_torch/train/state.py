"""Train state: module, optimizer, LR schedule, step count and generator.

Counterpart of ``dlsc_tpu/train/state.py``. The JAX state is an immutable
pytree replaced at every step; this one is updated in place (the module's
parameters and the optimizer's moments are the big buffers, and PyTorch
updates them where they lie).

The pipeline's random draws come from ``generator``, an explicit
``torch.Generator``: each step seeds one ``numpy.random.Generator`` from it
(``step_rng``), which draws the step's B-sized vectors on the host. Every
rank of a data-parallel run seeds it alike, so all draw the same.

``parallel`` is the model's layout over the ranks (``dlsc_tpu_torch.parallel``:
DDP, FSDP, expert or pipeline parallelism), None on one process: it runs
the forward (``parallel.module``), reduces the gradients it does not reduce
in the backward (``sync_grads``), clips by the norm over all the ranks'
shares (``clip_``), and gathers and scatters checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from dlsc_tpu_torch.train.optim import (OptimizerSpec, SchedulerSpec, build_optimizer,
                                        clip_by_global_norm_)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    lr_fn: Callable[[int], float]
    generator: torch.Generator
    clip: float | None = None   # global-norm clip ahead of the update
    step: int = 0               # optimizer steps taken
    parallel: Any = None        # the layout over the ranks, or None

    @classmethod
    def create(cls, model: nn.Module, optim: OptimizerSpec, sched: SchedulerSpec | None,
               steps_per_epoch: int, gradient_clip_val: float | None = None,
               seed: int = 0, swa: dict | None = None) -> "TrainState":
        opt, lr_fn = build_optimizer(model.parameters(), optim, sched, steps_per_epoch, swa)
        return cls(model, opt, lr_fn, torch.Generator().manual_seed(seed),
                   float(gradient_clip_val) if gradient_clip_val else None)

    def step_rng(self) -> np.random.Generator:
        """A fresh numpy generator for one step's draws, seeded from ``generator``."""
        return np.random.default_rng(
            int(torch.randint(0, 2**62, (), generator=self.generator)))

    def apply_gradients(self) -> None:
        """Give a parameter that the loss does not reach (LEAF's PCEN α) a
        zero gradient, as JAX's ``value_and_grad`` does, so that weight decay
        still moves it; clip (optax semantics), set the LR of this step
        count, update, clear the gradients, count the step."""
        params = [p for p in self.model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.parallel is not None:
            self.parallel.sync_grads()
        grads = [p.grad for p in params]
        if self.clip and self.parallel is not None:
            self.parallel.clip_(self.clip)
        elif self.clip:
            clip_by_global_norm_(grads, self.clip)
        lr = self.lr_fn(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
