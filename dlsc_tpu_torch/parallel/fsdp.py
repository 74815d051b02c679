"""FSDP: parameters and Adam moments sharded over the data ranks (FSDP2).

Counterpart of ``dlsc_tpu/parallel/fsdp.py`` (ZeRO-3 ``NamedSharding``s that
GSPMD all-gathers before each layer and reduce-scatters after it). Here
``fully_shard`` wraps each encoder ``Block`` (a ViT; other models have no
block stack), then the root: a block's parameters are all-gathered before
its forward (and again before a rematerialised block's recompute) and its
gradients reduce-scattered to the owners, averaged over the ranks. The
optimizer then holds each rank's shard of the parameters and moments.

The model keeps its mixed precision: f32 parameters, cast at use to the
compute dtype, as with one process (no ``MixedPrecisionPolicy``). The
kernels see the unsharded parameters as plain tensors.

Deviation, which changes no value: the JAX size gate (``MIN_SHARD_SIZE``,
``add_data_axis``: leaves under 16 384 elements replicated, 'data' on the
largest divisible dim) is a layout choice; FSDP2 shards dim 0 of every
parameter (padding an uneven last shard).

The data-parallel semantics are ``data.py``'s: each rank runs its rows,
BatchNorm and the MoE aux loss reduce over the ranks. Checkpoints hold the
full state dict: ``full_tensor`` of each parameter and moment, in the
one-process order (``Layout.full_names``); a restore cuts each rank's shard
from the full tensors (``distribute_tensor``, no communication).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import DTensor, distribute_tensor

from dlsc_tpu_torch.parallel.data import (Layout, clip_shares_, is_writer, optimizer_by_name,
                                          optimizer_by_name_from, optimizer_from_names,
                                          set_batch_group)
from dlsc_tpu_torch.parallel.mesh import MeshPlan


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _cpu(t):
    return t.detach().cpu() if isinstance(t, torch.Tensor) else t


class FullyShardedDP(Layout):
    """``fully_shard`` over the mesh's 'data' axis (see the module docstring)."""

    def __init__(self, model: nn.Module, plan: MeshPlan):
        super().__init__(model, plan)
        set_batch_group(model, plan.batch_group)
        mesh = plan.mesh["data"]
        for blk in getattr(model, "blocks", ()):
            fully_shard(blk, mesh=mesh)
        fully_shard(model, mesh=mesh)

    @contextlib.contextmanager
    def no_sync(self):
        self.model.set_requires_gradient_sync(False)
        try:
            yield
        finally:
            self.model.set_requires_gradient_sync(True)

    def clip_(self, max_norm: float) -> torch.Tensor:
        grads = [p.grad for p in self.params]
        local = [g.to_local() if isinstance(g, DTensor) else g for g in grads]
        return clip_shares_([(local, self.plan.batch_group)], local, max_norm)

    def full_state(self, state) -> dict | None:
        model = {k: _cpu(_full(v)) for k, v in self.model.state_dict().items()}
        by_name = optimizer_by_name(state.optimizer, self.full_names)
        by_name["state"] = {n: {k: _cpu(_full(v)) for k, v in st.items()}
                            for n, st in by_name["state"].items()}
        if not is_writer():
            return None
        return {"model": model, "optimizer": optimizer_from_names(by_name, self.full_names),
                "step": int(state.step), "generator": state.generator.get_state()}

    def load_state(self, state, ck: dict) -> None:
        self.load_model_state(ck["model"])
        params = dict(self.model.named_parameters())
        by_name = optimizer_by_name_from(ck["optimizer"], self.full_names)
        for name, st in by_name["state"].items():
            p = params[name]
            by_name["state"][name] = {k: _shard_like(v, p) for k, v in st.items()}
        state.optimizer.load_state_dict(optimizer_from_names(by_name, self.full_names))
        state.step = int(ck["step"])
        state.generator.set_state(ck["generator"])

    @torch.no_grad()
    def load_model_state(self, sd: dict) -> None:
        own = self.model.state_dict()
        for k, v in own.items():
            v.copy_(_shard_like(sd[k], v))


def _shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` laid out as ``like`` (a DTensor shard, or a plain tensor)."""
    if full.ndim == 0:   # Adam's step count stays where the optimizer keeps it
        return full
    if not isinstance(like, DTensor):
        return full.to(like.device)
    return distribute_tensor(full.to(like.device, like.dtype), like.device_mesh, like.placements,
                             src_data_rank=None)

