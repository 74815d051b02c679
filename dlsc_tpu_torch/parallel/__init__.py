"""The multi-device layer: process groups and the mesh, data parallelism
(DDP), FSDP, tensor (and sequence) parallelism, expert parallelism and
pipeline parallelism, on ``torch.distributed``.

Counterpart of ``dlsc_tpu/parallel/``. The invariant is the JAX
package's: a step on W ranks computes what the same step computes on one
device. ``make_plan`` and ``make_layout`` are what the Trainer builds from
its options; ``tp.tensor_parallel`` is a library function, as in JAX.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from dlsc_tpu_torch.parallel.data import DataParallel, Layout
from dlsc_tpu_torch.parallel.ep import ExpertParallel, check_moe
from dlsc_tpu_torch.parallel.fsdp import FullyShardedDP
from dlsc_tpu_torch.parallel.mesh import (MeshPlan, get_mesh, init_distributed, replicate,
                                          shard_batch, spawn, world_size)
from dlsc_tpu_torch.parallel.pp import Pipeline, get_pp_mesh


def make_plan(device_type: str, n_devices: int | None = None, expert_parallel: int = 1,
              pipeline_parallel: int = 1) -> MeshPlan:
    """The Trainer's mesh: ('data', 'stage') under pipeline parallelism,
    ('data', 'model') with the batch over both under expert parallelism,
    else ('data', 'model') with 'model' of size 1. No mesh in a process
    that has joined no group."""
    if not dist.is_initialized():
        return MeshPlan()
    if pipeline_parallel > 1:
        return MeshPlan(get_pp_mesh(n_devices, pipeline_parallel, device_type))
    if expert_parallel > 1:
        return MeshPlan(get_mesh(n_devices, expert_parallel, device_type), ("data", "model"))
    return MeshPlan(get_mesh(n_devices, 1, device_type))


def make_layout(model: nn.Module, plan: MeshPlan, device: torch.device, *, fsdp: bool = False,
                expert_parallel: int = 1, pipeline_parallel: int = 1,
                n_micro: int | None = None) -> Layout | None:
    """``model`` (on ``device``) laid out over ``plan``'s ranks as the
    options say: GPipe, expert parallelism (with FSDP over 'data' when
    ``fsdp``), FSDP or DDP; None without a
    mesh. Call before building the optimizer: the layouts replace or
    shard parameters."""
    if expert_parallel > 1:
        check_moe(model, expert_parallel)
    if plan.mesh is None:
        return None
    if pipeline_parallel > 1:
        return Pipeline(model, plan, n_micro or pipeline_parallel)
    if expert_parallel > 1:
        return ExpertParallel(model, plan, fsdp=fsdp)
    if fsdp:
        return FullyShardedDP(model, plan)
    return DataParallel(model, plan, device)


__all__ = ["DataParallel", "ExpertParallel", "FullyShardedDP", "Layout", "MeshPlan",
           "Pipeline", "get_mesh", "get_pp_mesh", "init_distributed", "make_layout",
           "make_plan", "replicate", "shard_batch", "spawn", "world_size"]
