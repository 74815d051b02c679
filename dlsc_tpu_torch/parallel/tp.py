"""Tensor (Megatron) and sequence parallelism for the ViT family.

Counterpart of ``dlsc_tpu/parallel/tp.py`` (column/row ``NamedSharding``s
over 'model'), the head-sharded attention of ``models/vit.py:87-124`` and
``:158-200`` (``_head_sharded_mha``: the kernels under ``shard_map`` on
H/tp heads), the token sharding of ``vit.py:691-725`` and the MoE block of
``dlsc_tpu/parallel/pp_tp.py:150-173``. JAX expresses the splits as
shardings and GSPMD inserts the collectives; the port writes them, the way
``dlsc_tpu/parallel/pp_tp.py`` does inside its pipeline:

- attention qkv and MLP fc1 are column-parallel (their output units split),
  proj and fc2 row-parallel (their input units split); norms, embeddings
  and the head are replicated. The forward all-reduces after each
  row-parallel product (two a block), the backward before each
  column-parallel one;
- packed qkv: the port's attention views the qkv output as (B, N, 3, H, dh)
  ([q|k|v] column order). A plain split of the 3·D rows would hand rank 0
  all of q and part of k, so each rank takes its heads' rows of q, k and v:
  (3, H/tp, dh);
- the attention core runs on the rank's H/tp heads with plain local
  tensors, so K2 (and K3 under ``ln_fused``) need no sharding rule: what
  ``shard_map`` does for the Pallas kernels, or ``local_map`` for DTensor
  code. The parameters are plain local tensors too, not DTensors;
- MoE blocks (``models/moe.MoeMlp``): each expert's hidden dim F is split,
  wi (E, D, F) and bi (E, F) by columns, wo (E, F, D) by rows; the router
  and bo are replicated, so every rank routes the replicated input alike
  and counts the aux loss, the z-loss and the ``moe/*`` stats once. The
  rank's partial expert outputs are combined with the gates and summed over
  the ranks, bo divided by tp inside the sum as ``pp_tp.py:162`` does (its
  gradient is then summed over the ranks: ``sync_grads``); the experts'
  input and the combine weights take their summed gradient in the backward
  (``MoeSplit.copy_in``), so the router's gradient is whole on every rank.
  Every dispatch and router runs so: the ragged one through K4a/K4b at
  F/tp, the capacity ones, expert-choice. Under sequence parallelism the
  block gathers its tokens before the router (every rank routes them all)
  and reduce-scatters its output. Expert parallelism does not compose with
  it (JAX's message), and tp must divide F;
- attention dropout takes the dense path, as in JAX (``vit.py:120``); every
  dropout mask is the unsplit tensor's at the rank's heads, units or
  tokens (a counter-based draw, ``ops/dropout_draw.py``: a rank computes
  its own elements' bits only), so a TP step draws what the one-process
  step draws (the MoE output's mask is the same on every rank);
- ``sequence_parallel`` is the counterpart of ``token_sharding``: between
  the column and row products the activations are split over the tokens
  (LayerNorm, residuals and dropout on N/tp tokens), the all-reduces become
  an all-gather before each column product and a reduce-scatter after each
  row product, and the replicated parameters inside the blocks, whose
  gradients are then partial sums, are summed over the ranks (but the MoE
  routers, which see every token on every rank).

The split lives in this module alone: ``TensorParallel`` cuts each
block's qkv, proj, fc1 and fc2 (or wi, bi and wo) and replaces its
``Attention`` and ``Mlp`` by ``ParallelAttention`` and ``ParallelMlp``,
subclasses that override the products (``project_in``, ``project_out``: the
collectives) and the parts of the unsplit dropout draws (``part``,
``hidden_part``, ``out_part``); a ``MoeMlp`` gets a ``MoeSplit``.
The collectives are autograd functions on ``torch.distributed``; the
reduce-scatter is an all-reduce and a slice (one collective that every
backend has).

Why not DTensor's ``parallelize_module`` (``ColwiseParallel`` /
``RowwiseParallel``) with ``local_map`` around K2: its styles would still
need the qkv rows re-laid out by hand, the kernels and the dropout masks
need the rank's local heads and units anyway, and DTensor parameters would
reach the pipeline (``pp_tp.py``), the clipping and the checkpoint
gathers, which all work on plain local tensors. The hand-written split is
the two Megatron functions (f, g) and their sequence-parallel pair, which
is what JAX's ``pp_tp.py`` writes too.

TP is a library function, as in the JAX package: the Trainer has no TP
option. ``TensorParallel`` is the layout for ``TrainState``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from dlsc_tpu_torch.models.moe import MoeMlp
from dlsc_tpu_torch.models.vit import Attention, Mlp
from dlsc_tpu_torch.parallel.data import (Layout, clip_shares_, is_writer, optimizer_by_name,
                                          optimizer_from_names, sum_grads)
from dlsc_tpu_torch.parallel.mesh import MeshPlan


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _own(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, i = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(n, dim)[i].contiguous()


class _CopyIn(torch.autograd.Function):
    """Identity; the backward sums the gradient over the ranks (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """Sum over the ranks; the backward is the identity (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTokens(torch.autograd.Function):
    """All-gather along dim 1. Backward: the rank's slice of the gradient,
    summed over the ranks first when ``reduce_grad`` (the consumers are
    split: a column product) and not when they are replicated (the head)."""

    @staticmethod
    def forward(ctx, x, group, reduce_grad):
        ctx.group, ctx.reduce_grad = group, reduce_grad
        return _all_gather(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            g = _all_reduce(g, ctx.group)
        return _own(g, 1, ctx.group), None, None


class _ScatterTokens(torch.autograd.Function):
    """Reduce-scatter along dim 1 (sum over the ranks, keep the rank's
    tokens); the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _own(_all_reduce(x, group), 1, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, 1, ctx.group), None


class _SplitTokens(torch.autograd.Function):
    """The rank's tokens of a replicated tensor; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _own(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, 1, ctx.group), None


class TokenShard:
    """``ASTViT.token_shard``: the encoder's tokens split over ``group``."""

    def __init__(self, group):
        self.group = group

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % dist.get_world_size(self.group):
            raise ValueError(f"{x.shape[1]} tokens are not divisible by the "
                             f"{dist.get_world_size(self.group)} ranks")
        return _SplitTokens.apply(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherTokens.apply(x, self.group, False)


def _column(x: torch.Tensor, layer: nn.Linear, group, sp: bool) -> torch.Tensor:
    """A column-parallel product: the rank's output units."""
    x = _GatherTokens.apply(x, group, True) if sp else _CopyIn.apply(x, group)
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _row(x: torch.Tensor, layer: nn.Linear, group, sp: bool) -> torch.Tensor:
    """A row-parallel product on the rank's input units, summed over the
    ranks; the whole bias added once, after the sum."""
    y = F.linear(x, layer.weight.to(x.dtype))
    y = _ScatterTokens.apply(y, group) if sp else _ReduceOut.apply(y, group)
    return y + layer.bias.to(y.dtype)


class ParallelAttention(Attention):
    """``Attention`` on a rank's H/tp heads, built from the unsplit module
    whose qkv and proj the layout has cut: qkv column-parallel (the rank's
    heads of q, k and v), proj row-parallel, the dropout masks of the
    rank's heads of the attention probabilities (B, H, N, N)."""

    def __init__(self, attn: Attention, layout: TensorParallel):
        nn.Module.__init__(self)
        self.impl, self.rate, self.quant = attn.impl, attn.rate, None
        self.num_heads = attn.num_heads // layout.tp
        self.qkv, self.proj = attn.qkv, attn.proj
        self.group, self.sp = layout.group, layout.sp
        self.part = (1, layout.t, layout.tp)

    def project_in(self, x: torch.Tensor) -> torch.Tensor:
        return _column(x, self.qkv, self.group, self.sp)

    def project_out(self, x: torch.Tensor) -> torch.Tensor:
        return _row(x, self.proj, self.group, self.sp)


class ParallelMlp(Mlp):
    """``Mlp`` on a rank's hidden units, built from the unsplit module whose
    fc1 and fc2 the layout has cut: fc1 column-parallel, fc2 row-parallel;
    the dropout masks of the rank's hidden units (B, N, F), and under
    sequence parallelism of its tokens of the output (B, N, D)."""

    def __init__(self, mlp: Mlp, layout: TensorParallel):
        nn.Module.__init__(self)
        self.rate, self.quant = mlp.rate, None
        self.fc1, self.fc2 = mlp.fc1, mlp.fc2
        if hasattr(mlp, "hyper_rate"):
            self.register_buffer("hyper_rate", mlp.hyper_rate)
        self.group, self.sp = layout.group, layout.sp
        self.hidden_part = (2, layout.t, layout.tp)
        self.out_part = (1, layout.t, layout.tp) if layout.sp else None

    def project_in(self, x: torch.Tensor) -> torch.Tensor:
        return _column(x, self.fc1, self.group, self.sp)

    def project_out(self, x: torch.Tensor) -> torch.Tensor:
        return _row(x, self.fc2, self.group, self.sp)


class MoeSplit:
    """``MoeMlp.tp``: a rank's share of every expert's hidden units, the
    ``t``-th of ``tp`` over ``group``, and the collectives; ``sp``: the
    block's tokens are split over the ranks too."""

    def __init__(self, group, t: int, tp: int, sp: bool = False):
        self.group, self.t, self.tp, self.sp = group, t, tp, sp

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Under sequence parallelism every rank's tokens (the backward
        keeps the rank's slice of a gradient that is whole on every rank:
        the router's, and the experts' after ``copy_in``); else x."""
        return _GatherTokens.apply(x, self.group, False) if self.sp else x

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """Identity; the backward sums the gradient over the ranks."""
        return _CopyIn.apply(x, self.group)

    def reduce_out(self, y: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks (under sequence parallelism, the rank's
        tokens of it); the backward is the identity (or the all-gather)."""
        if self.sp:
            return _ScatterTokens.apply(y, self.group)
        return _ReduceOut.apply(y, self.group)


def _qkv_rows(D: int, H: int, t: int, tp: int) -> torch.Tensor:
    """The rows of the packed (3·D) qkv output that hold rank t's heads of
    q, k and v, in (3, H/tp, dh) order."""
    dh, hl = D // H, H // tp
    per = torch.arange(t * hl * dh, (t + 1) * hl * dh)
    return torch.cat([p * D + per for p in range(3)])


# a block's split parameters: 'qkv' (the rank's heads of q, k and v) or the
# dim cut into tp parts (a Linear's output units 0, input units 1; an
# expert's hidden units: wi's 2, bi's and wo's 1); a row-parallel bias and
# the MoE router and bo stay whole
_SPLITS = {"attn.qkv.weight": "qkv", "attn.qkv.bias": "qkv", "attn.proj.weight": 1,
           "mlp.fc1.weight": 0, "mlp.fc1.bias": 0, "mlp.fc2.weight": 1,
           "moe.wi": 2, "moe.bi": 1, "moe.wo": 1}
EP_TP_ERROR = ("pp×tp does not compose with expert_sharding (GSPMD constraints cannot appear "
               "inside the pipeline's shard_map); build the model with expert_sharding=None")


class TensorParallel(Layout):
    """A ViT split over a 'model' axis (see the module docstring); the
    batch is not split (``plan.n_batch`` 1 on a pure 'model' mesh)."""

    def __init__(self, model: nn.Module, mesh: DeviceMesh, sequence_parallel: bool = False,
                 axis: str = "model"):
        super().__init__(model, MeshPlan(mesh))
        if getattr(model, "quant", None):
            raise ValueError("tensor parallelism trains float weights: quant is inference-only")
        self.group = mesh.get_group(axis)
        self.t, self.tp = mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))
        self.sp = sequence_parallel
        D = model.config["emb_dim"]
        self.H = model.config["num_heads"]
        self.D = D
        if self.H % self.tp:
            raise ValueError(f"num_heads={self.H} not divisible by {self.tp} tensor-parallel ranks")
        self.split = {}   # parameter name -> kind
        partial = set()   # parameters whose gradients are partial sums over the ranks
        with torch.no_grad():
            for i, blk in enumerate(model.blocks):
                if not hasattr(blk, "attn"):   # a block another pipeline stage holds
                    continue
                if hasattr(blk, "moe"):
                    self._check_moe(blk.moe)
                for suffix, kind in _SPLITS.items():
                    *path, pname = suffix.split(".")
                    owner = blk
                    for name in path:
                        owner = getattr(owner, name, None)
                    if owner is None:
                        continue
                    full = getattr(owner, pname)
                    setattr(owner, pname, nn.Parameter(self._cut(kind, full)))
                    self.split[f"blocks.{i}.{suffix}"] = kind
                blk.attn = ParallelAttention(blk.attn, self)
                if hasattr(blk, "moe"):
                    blk.moe.tp = MoeSplit(self.group, self.t, self.tp, self.sp)
                    partial.add(f"blocks.{i}.moe.bo")
                else:
                    blk.mlp = ParallelMlp(blk.mlp, self)
        if self.sp:
            model.token_shard = TokenShard(self.group)
            # replicated parameters inside the blocks: partial gradients under SP
            # (the MoE routers' are whole: they route every token on every rank)
            partial |= {n for n, _ in model.named_parameters()
                        if n.startswith("blocks.") and n not in self.split
                        and ".moe.router." not in n}
        self.partial = [p for n, p in model.named_parameters() if n in partial]

    def _check_moe(self, moe: MoeMlp) -> None:
        """The JAX refusals (``pp_tp.py:272-276``, ``:283-288``)."""
        if moe.ep_group is not None:
            raise ValueError(EP_TP_ERROR)
        hidden = moe.wi.shape[-1]
        if hidden % self.tp:
            raise ValueError(f"expert hidden {hidden} not divisible by model axis {self.tp}")

    def _cut(self, kind: str | int, full: torch.Tensor) -> torch.Tensor:
        if kind == "qkv":
            return full[_qkv_rows(self.D, self.H, self.t, self.tp)].clone()
        return full.chunk(self.tp, kind)[self.t].clone()

    def _merge(self, name: str, parts: list[torch.Tensor]) -> torch.Tensor:
        kind = self.split[name]
        if kind != "qkv":
            return torch.cat(parts, kind)
        full = torch.empty((3 * self.D,) + tuple(parts[0].shape[1:]), dtype=parts[0].dtype)
        for t, p in enumerate(parts):
            full[_qkv_rows(self.D, self.H, t, self.tp)] = p
        return full

    def sync_grads(self) -> None:
        if self.partial:
            sum_grads(self.partial, self.group)

    def clip_(self, max_norm: float) -> torch.Tensor:
        named = list(self.model.named_parameters())
        split = [p.grad for n, p in named if n in self.split]
        whole = [p.grad for n, p in named if n not in self.split]
        return clip_shares_([(whole, None), (split, self.group)], split + whole, max_norm)

    def _gather(self, tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        parts = [None] * self.tp
        dist.all_gather_object(parts, {k: v.detach().cpu() for k, v in tensors.items()},
                               group=self.group)
        return {k: self._merge(k.split("/")[0], [p[k] for p in parts]) for k in tensors}

    def full_model_state(self) -> dict[str, torch.Tensor]:
        """The unsplit model state dict (on every rank)."""
        sd = {k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()}
        sd.update(self._gather({k: sd[k] for k in self.split}))
        return sd

    def full_optimizer_by_name(self, state) -> dict:
        """The optimizer state by name with the split moments merged (on
        every rank)."""
        from dlsc_tpu_torch.train.checkpoint import _to_cpu

        by_name = _to_cpu(optimizer_by_name(state.optimizer, self.full_names))
        st = by_name["state"]
        moments = {f"{n}/{k}": v for n in self.split if n in st
                   for k, v in st[n].items() if v.ndim > 0}
        for key, v in self._gather(moments).items():
            n, k = key.split("/")
            st[n] = {**st[n], k: v}
        return by_name

    def cut(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole parameter or moment ``name``."""
        if name not in self.split:
            return full
        return self._cut(self.split[name], full)

    def full_state(self, state) -> dict | None:
        model = self.full_model_state()
        by_name = self.full_optimizer_by_name(state)
        if not is_writer():
            return None
        return {"model": model, "optimizer": optimizer_from_names(by_name, self.full_names),
                "step": int(state.step), "generator": state.generator.get_state()}

    def load_model_state(self, sd: dict) -> None:
        self.model.load_state_dict({k: self.cut(k, v) for k, v in sd.items()})


def tensor_parallel(model: nn.Module, mesh: DeviceMesh, sequence_parallel: bool = False,
                    axis: str = "model") -> TensorParallel:
    """Split ``model`` (an ``ASTViT``, in place) over ``mesh``'s ``axis``
    and return its layout; pass it as ``TrainState.parallel``."""
    return TensorParallel(model, mesh, sequence_parallel, axis)
