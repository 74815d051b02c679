"""Expert parallelism: each MoE layer's experts split over the 'model' ranks.

Counterpart of ``dlsc_tpu/parallel/ep.py`` and ``models/moe.py:151-170``,
``:236-269``. There the stacked expert weights (wi, wo, bi, bo; leading
expert axis E) and their Adam moments carry a 'model' sharding, the router
is replicated, and GSPMD exchanges the (B, E, C, D) dispatch buffers.
Here:

- ``shard_experts`` keeps this rank's E / ep experts of each MoE layer
  (``wi[e0:e1]``, ...), so the optimizer holds their moments only; the
  router and everything else stay whole;
- the capacity buffers cross ranks in ``MoeMlp._ffn`` through an
  autograd-aware ``all_to_all_single`` (``models/moe._expert_parallel``);
- ``dispatch='ragged'`` lowers to ``'einsum'`` under expert sharding, as in
  JAX (``moe.py:236``, ``:269``): the grouped products have no
  expert-sharded form.

``ExpertParallel`` is the Trainer's layout (``expert_parallel`` > 1). The
JAX mesh shards the batch over 'data' only and runs each row on every
'model' rank; here the batch is split over all the ranks, ('data', 'model')
row-major, so that the all-to-all moves distinct rows (the dispatch of
DeepSpeed-MoE and GShard's implementations): the values are the same, each
row's computation being the one-process one. Gradients: every parameter but
the experts is averaged over all ranks; an expert's gradient, which its
rank collects from the rows of its whole 'model' group (scaled by 1 / ep
in the exchange, ``models/moe._expert_parallel``), is averaged over the
'data' ranks holding the same experts.

FSDP + EP (``fsdp=True``), as ``fsdp_ep_state_shardings``: the experts on
'model', everything sharded over 'data' by FSDP2. Each MoE layer's experts
(``fully_shard`` of the ``MoeMlp`` over the 'data' ranks of its 'model'
coordinate) and everything else (HSDP: replicated over 'model', sharded
over 'data') are separate FSDP units; the router is its own unit, so that
it is not sharded with the experts.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import DTensor

from dlsc_tpu_torch.models.moe import MoeMlp
from dlsc_tpu_torch.parallel.data import (Layout, clip_shares_, is_writer, optimizer_by_name,
                                          optimizer_by_name_from, optimizer_from_names,
                                          set_batch_group, sum_grads)
from dlsc_tpu_torch.parallel.fsdp import _full, _shard_like
from dlsc_tpu_torch.parallel.mesh import MeshPlan

#: MoeMlp parameters with a leading expert axis
EXPERT_PARAMS = ("wi", "bi", "wo", "bo")


@dataclasses.dataclass(frozen=True)
class ExpertSharding:
    """This rank's experts: the ``index``-th of ``count`` equal parts of each
    MoE layer's, exchanged over ``group``."""

    group: dist.ProcessGroup
    index: int
    count: int


def expert_sharding(plan: MeshPlan, axis: str = "model") -> ExpertSharding:
    """The expert sharding of ``plan``'s ``axis``; pass as
    ``ASTMoE(expert_sharding=...)``."""
    return ExpertSharding(plan.mesh.get_group(axis), plan.coordinate(axis), plan.size(axis))


def expert_names(model: nn.Module) -> list[str]:
    """State-dict names of the expert-stacked MoE parameters."""
    return [f"{name}.{p}" for name, m in model.named_modules() if isinstance(m, MoeMlp)
            for p in EXPERT_PARAMS]


@torch.no_grad()
def shard_experts(model: nn.Module, sh: ExpertSharding) -> list[str]:
    """Keep ``sh``'s experts of every MoE layer of ``model`` (in place);
    return the names of the sharded parameters."""
    for m in model.modules():
        if not isinstance(m, MoeMlp):
            continue
        E = m.spec.n_experts
        if E % sh.count:
            raise ValueError(f"model.n_experts={E} must be divisible by "
                             f"trainer.expert_parallel={sh.count}")
        el = E // sh.count
        for name in EXPERT_PARAMS:
            full = getattr(m, name)
            setattr(m, name, nn.Parameter(full[sh.index * el:(sh.index + 1) * el].clone()))
        m.ep_group = sh.group
        if m.spec.dispatch == "ragged":
            m.spec = dataclasses.replace(m.spec, dispatch="einsum")
    return expert_names(model)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def check_moe(model: nn.Module, expert_parallel: int) -> None:
    """The Trainer's checks (``dlsc_tpu/train/loop.py:584-596``)."""
    moes = [m for m in model.modules() if isinstance(m, MoeMlp)]
    if not moes:
        raise ValueError("trainer.expert_parallel requires a MoE model (e.g. model=ast_moe)")
    n = moes[0].spec.n_experts
    if n % expert_parallel:
        raise ValueError(f"model.n_experts={n} must be divisible by "
                         f"trainer.expert_parallel={expert_parallel}")


class ExpertParallel(Layout):
    """The Trainer's expert-parallel layout (see the module docstring)."""

    def __init__(self, model: nn.Module, plan: MeshPlan, fsdp: bool = False):
        super().__init__(model, plan)
        self.ep_group = plan.mesh.get_group("model")
        self.data_group = plan.mesh.get_group("data")
        self.index, self.count = plan.coordinate("model"), plan.size("model")
        set_batch_group(model, plan.batch_group)
        self.experts = set(shard_experts(model, ExpertSharding(self.ep_group, self.index,
                                                               self.count)))
        self.fsdp = fsdp
        if fsdp:
            # (model, data): replicated over 'model', sharded over 'data'
            hsdp = DeviceMesh(plan.mesh.device_type, plan.mesh.mesh.t(),
                              mesh_dim_names=("model", "data"))
            for blk in model.blocks:
                if hasattr(blk, "moe"):
                    fully_shard(blk.moe.router, mesh=hsdp)
                    fully_shard(blk.moe, mesh=plan.mesh["data"])
                fully_shard(blk, mesh=hsdp)
            fully_shard(model, mesh=hsdp)

    def no_sync(self):
        if not self.fsdp:
            return super().no_sync()
        from dlsc_tpu_torch.parallel.fsdp import FullyShardedDP

        return FullyShardedDP.no_sync(self)

    def _split(self) -> tuple[list[nn.Parameter], list[nn.Parameter]]:
        named = list(self.model.named_parameters())
        return ([p for n, p in named if n in self.experts],
                [p for n, p in named if n not in self.experts])

    def sync_grads(self) -> None:
        if self.fsdp:   # FSDP2 averaged them in the backward
            return
        experts, others = self._split()
        sum_grads(others, dist.group.WORLD, 1.0 / self.plan.n_batch)
        sum_grads(experts, self.data_group, 1.0 / self.plan.n_data)

    def clip_(self, max_norm: float) -> torch.Tensor:
        experts, others = self._split()
        ge, go = ([_local(p.grad) for p in ps] for ps in (experts, others))
        if self.fsdp:   # shards over 'data'; the experts' also over 'model'
            return clip_shares_([(go, self.data_group), (ge, dist.group.WORLD)], ge + go,
                                max_norm)
        return clip_shares_([(go, None), (ge, self.ep_group)], ge + go, max_norm)

    def _gather(self, local: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """{name: the experts of every rank of the group, in order} from this
        rank's ``local`` expert tensors."""
        parts = [None] * self.count
        dist.all_gather_object(parts, {k: v.detach().cpu() for k, v in local.items()},
                               group=self.ep_group)
        return {k: torch.cat([p[k] for p in parts]) for k in local}

    def _cut(self, full: torch.Tensor) -> torch.Tensor:
        el = full.shape[0] // self.count
        return full[self.index * el:(self.index + 1) * el]

    def full_state(self, state) -> dict | None:
        model = {k: _full(v).detach().cpu() for k, v in self.model.state_dict().items()}
        model.update(self._gather({k: model[k] for k in self.experts}))
        by_name = optimizer_by_name(state.optimizer, self.full_names)
        st = by_name["state"] = {n: {k: _full(v).detach().cpu() if isinstance(v, torch.Tensor)
                                     else v for k, v in s.items()}
                                 for n, s in by_name["state"].items()}
        moments = {f"{n}/{k}": v for n in self.experts if n in st
                   for k, v in st[n].items() if v.ndim > 0}
        for key, v in self._gather(moments).items():
            n, k = key.split("/")
            st[n] = {**st[n], k: v}
        if not is_writer():
            return None
        return {"model": model, "optimizer": optimizer_from_names(by_name, self.full_names),
                "step": int(state.step), "generator": state.generator.get_state()}

    @torch.no_grad()
    def load_model_state(self, sd: dict) -> None:
        own = self.model.state_dict()
        for k, v in own.items():
            v.copy_(_shard_like(self._cut(sd[k]) if k in self.experts else sd[k], v))

    def load_state(self, state, ck: dict) -> None:
        self.load_model_state(ck["model"])
        by_name = optimizer_by_name_from(ck["optimizer"], self.full_names)
        params = dict(self.model.named_parameters())
        for n, st in by_name["state"].items():
            by_name["state"][n] = {
                k: _shard_like(self._cut(v) if n in self.experts and v.ndim > 0 else v,
                               params[n]) for k, v in st.items()}
        state.optimizer.load_state_dict(optimizer_from_names(by_name, self.full_names))
        state.step = int(ck["step"])
        state.generator.set_state(ck["generator"])
