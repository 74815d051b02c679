"""Data parallelism: DDP over the ranks that split the global batch, and
what every layout of a model over the ranks shares.

The counterpart of the JAX package's batch-sharded ``jit``
(``dlsc_tpu/train/loop.py:290-351``, ``steps.py``): there GSPMD runs the
step over the global batch, so its statistics and its gradients are the
global batch's. Here each rank runs its rows (``MeshPlan.rows``) and:

- DDP averages the ranks' gradients (each rank's loss is the mean over its
  rows, so the average is the global batch's gradient);
- the model's BatchNorm layers and MoE blocks reduce their statistics over
  the ranks (``set_batch_group``): SyncBatchNorm's semantics, and the MoE
  aux loss as a product of global means;
- the metric states are summed over the ranks (``MetricState.reduced``).

``Layout`` is one process's model, the interface that ``TrainState.parallel``
holds; ``DataParallel`` and the FSDP, expert and pipeline layouts
(``fsdp.py``, ``ep.py``, ``pp.py``) implement it. A checkpoint always
holds the full state dict, gathered to rank 0 (``full_state``), so that
``restore_state``, a resume at any number of ranks, ``export`` and
``serve`` read it unchanged; ``load_state`` puts a full state back into the
layout.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from dlsc_tpu_torch.models.layers import BatchNorm
from dlsc_tpu_torch.models.moe import MoeMlp
from dlsc_tpu_torch.parallel.mesh import MeshPlan
from dlsc_tpu_torch.train.optim import clip_by_global_norm_


def is_writer() -> bool:
    """Whether this process writes files (checkpoints, the tracker, the
    epoch line): rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def set_batch_group(model: nn.Module, group: dist.ProcessGroup | None) -> None:
    """Reduce the statistics of ``model``'s BatchNorm layers and MoE blocks
    over ``group`` (None: this rank's rows alone)."""
    for m in model.modules():
        if isinstance(m, (BatchNorm, MoeMlp)):
            m.group = group


def optimizer_by_name_from(sd: dict, names: list[str]) -> dict:
    """A one-group ``torch.optim`` state dict (an optimizer's or a
    checkpoint's) keyed by parameter name, ``names`` in the group's order."""
    (group,) = sd["param_groups"]
    return {"state": {names[int(i)]: dict(st) for i, st in sd["state"].items()},
            "group": {k: v for k, v in group.items() if k != "params"}}


def optimizer_by_name(opt: torch.optim.Optimizer, names: list[str]) -> dict:
    """``opt.state_dict()`` keyed by parameter name."""
    return optimizer_by_name_from(opt.state_dict(), names)


def optimizer_from_names(by_name: dict, names: list[str]) -> dict:
    """The ``torch.optim`` state dict of a one-group optimizer over the
    parameters ``names`` from ``optimizer_by_name``'s form."""
    return {"state": {i: by_name["state"][n] for i, n in enumerate(names)
                      if n in by_name["state"]},
            "param_groups": [{**by_name["group"], "params": list(range(len(names)))}]}


@torch.no_grad()
def sum_grads(params: list[nn.Parameter], group: dist.ProcessGroup | None,
              scale: float = 1.0) -> None:
    """Sum the gradients of ``params`` over ``group`` (one flat all-reduce
    per dtype), then scale them. A missing gradient counts as zero."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        if group is not None or dist.is_initialized():
            dist.all_reduce(flat, group=group)
        if scale != 1.0:
            flat.mul_(scale)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


@torch.no_grad()
def clip_shares_(shares: list[tuple[list[torch.Tensor], dist.ProcessGroup | None]],
                 all_grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's global-norm clip (``optim.clip_by_global_norm_``) of
    gradients held in shares: ``shares`` lists (local tensors, the group or
    groups over which their squared norms add up; None: every rank holds
    the same ones), and every gradient in ``all_grads`` is scaled."""
    total = None
    for tensors, groups in shares:
        sq = torch.stack([t.float().square().sum() for t in tensors]).sum() if tensors \
            else torch.zeros((), device=all_grads[0].device)
        for group in groups if isinstance(groups, tuple) else (groups,):
            if group is not None:
                dist.all_reduce(sq, group=group)
        total = sq if total is None else total + sq
    norm = total.sqrt()
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in all_grads:
        g.mul_(scale.to(g.dtype))
    return norm


class Layout:
    """One process's model: the forward module is the model; gradients,
    clipping and checkpoints are local. The base of the multi-rank layouts."""

    #: whether the layout runs the train and eval forward itself (pipeline)
    runs_step = False

    def __init__(self, model: nn.Module, plan: MeshPlan):
        self.model, self.plan = model, plan
        self.module: nn.Module = model
        # the full model's parameter names, in order: a checkpoint's
        # optimizer state is indexed by them
        self.full_names = [n for n, _ in model.named_parameters()]

    @property
    def local_names(self) -> list[str]:
        """This rank's parameter names, in the optimizer's order."""
        return [n for n, _ in self.model.named_parameters()]

    @property
    def params(self) -> list[nn.Parameter]:
        return [p for p in self.model.parameters() if p.requires_grad]

    def no_sync(self):
        """Context of a micro-batch whose gradients are not reduced yet."""
        return contextlib.nullcontext()

    def sync_grads(self) -> None:
        """Reduce what the backward did not reduce (nothing here)."""

    def clip_(self, max_norm: float) -> torch.Tensor:
        return clip_by_global_norm_([p.grad for p in self.params], max_norm)

    def mean_over_batch(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of a per-rank value over the ranks of the batch."""
        group = self.plan.batch_group
        if group is None:
            return t
        t = t.detach().clone()
        dist.all_reduce(t, group=group)
        return t / self.plan.n_batch

    def reduce_metrics(self, ms):
        return ms.reduced(self.plan.batch_group)

    def gather_rows(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """The (n, ...) tensor of the global batch from each rank's rows
        ``t`` (a zero-padded all-reduce, which every backend has)."""
        group = self.plan.batch_group
        if group is None:
            return t
        lo, hi = self.plan.rows(n)
        full = t.new_zeros((n,) + tuple(t.shape[1:]))
        full[lo:hi] = t
        dist.all_reduce(full, group=group)
        return full

    def full_state(self, state) -> dict | None:
        """The full checkpoint dict (``train/checkpoint.py``), on rank 0;
        None elsewhere. Every rank must call it."""
        from dlsc_tpu_torch.train.checkpoint import plain_state_dict

        return plain_state_dict(state) if is_writer() else None

    def load_state(self, state, ck: dict) -> None:
        """Load a full checkpoint dict into the layout (every rank)."""
        from dlsc_tpu_torch.train.checkpoint import load_plain_state_dict

        load_plain_state_dict(state, ck)

    def load_model_state(self, sd: dict) -> None:
        """Load full model weights (a warm start)."""
        self.model.load_state_dict(sd)


class DataParallel(Layout):
    """DDP over ``plan.batch_group``: the model is replicated, each rank
    runs its rows, gradients are averaged in the backward, BatchNorm and
    the MoE aux loss see the global batch (``set_batch_group``). DDP looks
    for parameters without a gradient (a walk of the autograd graph every
    step) only on a model that names some as ``unreached_parameters``
    (LEAF's PCEN α); every other model's loss reaches all its parameters."""

    def __init__(self, model: nn.Module, plan: MeshPlan, device: torch.device):
        super().__init__(model, plan)
        set_batch_group(model, plan.batch_group)
        self.module = DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None,
            process_group=plan.batch_group or dist.group.WORLD, broadcast_buffers=False,
            find_unused_parameters=bool(getattr(model, "unreached_parameters", ())))

    def no_sync(self):
        return self.module.no_sync()

